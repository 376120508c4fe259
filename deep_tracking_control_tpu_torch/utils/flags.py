"""The strict-parity master switch.

`DTC_STRICT_PARITY=1` restores the reference's all-f32 rollout storage
(rollout_storage.py:30-60) in place of the bf16 storage of the privileged
obs and the obs history, and the reference's update: sequential
VAE-then-policy steps over a per-row permutation in one stratum
(runner/train.py, agent/ppo.py).  The JAX package's other DTC_* switches
choose between its Pallas kernels and XLA paths; this package has one
path per function (a CUDA kernel on the card, its plain version on the
CPU), so they have no counterpart here.
"""
import os


def strict_parity() -> bool:
    return os.environ.get("DTC_STRICT_PARITY", "0") == "1"
