"""The DTC_* route switches and the strict-parity master switch.

Counterpart of the JAX package's utils/flags.py.  `DTC_STRICT_PARITY=1`
flips every deliberate deviation from the reference's semantics off at
once: the reference's all-f32 rollout storage (rollout_storage.py:30-60)
in place of the bf16 storage of the privileged obs and the obs history,
the reference's update (sequential VAE-then-policy steps over a per-row
permutation in one stratum; runner/train.py, agent/ppo.py), and every
`kernel_flag` gate below.

The gates choose the route through `LeggedEnv.step`, read where the JAX
package reads them:

  * DTC_PALLAS_PHYSICS (env init): the decimation kernel, or the plain
    decimation loop over `sim_step` on materialized patches;
  * DTC_PALLAS_SAMPLER (each step): the fused terrain sampler, or the
    3-table patch copy (K4) and the plain samplers;
  * DTC_FUSED_WINDOW (each step, sampler on): the decimation kernel reads
    its contact window from the blocked table, or from the window copy
    (K5);
  * DTC_PALLAS_PLANNER (each step): the fused foothold planner, or the
    plain one.

The reward, obs, noise and gather kernels stay on every route: they
compute the function of the XLA rewards, obs and gather that the JAX
package's strict route runs, and their noise stream differs from JAX's
by design (a Philox stream in place of jax.random) on every route alike.
"""
import os


def strict_parity() -> bool:
    return os.environ.get("DTC_STRICT_PARITY", "0") == "1"


def kernel_flag(name: str, default: str) -> bool:
    """Read a DTC_* kernel/deviation gate ("0" = off, anything else = on).

    Strict-parity mode forces every gate off regardless of its own env var.
    """
    if strict_parity():
        return False
    return os.environ.get(name, default) != "0"
