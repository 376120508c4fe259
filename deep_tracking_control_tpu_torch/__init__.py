"""deep_tracking_control_tpu_torch — the PyTorch/CUDA port of Deep Tracking
Control.

The counterpart of the JAX package ``deep_tracking_control_tpu`` for an
NVIDIA Hopper GPU: the same physics, terrain, environment and networks as
plain PyTorch, with every kernel on the rollout path written by hand in
CUDA C++ (``csrc/``, built with nvcc at first use, bound with ctypes).

The package imports torch and numpy only.  On a CPU tensor each kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.
"""
__version__ = "0.1.0"
