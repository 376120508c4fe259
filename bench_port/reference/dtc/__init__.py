"""A frozen copy of deep_tracking_control_tpu_torch's plain paths (the
modules the environment, the decoder network and PPO need), with the
CUDA kernel launches taken out so that each kernel wrapper runs its plain
version on every device.  The docstrings are the port's; where they speak
of a kernel, the plain version beside it is what runs here.  Relative
imports keep the port's layout."""
