"""Bytes and operations of each hand-written kernel launch, frozen from
shapes, and the roofline bound they set.

bench_port/counts/kernels.json holds, for each configuration, each
kernel's bytes read, bytes written and operations a launch as a + b * N
over N envs (the layer's widths are the configuration's, so every count
is linear in the env count).  derive.py wrote them from the port's plain
versions on the CPU and tests/test_bench_counts.py derives them again.
The rules, as the port's chip_smoke.py counted a kernel's bound:
  * bytes: every tensor argument read once and every result written
    once; the terrain tables by the cells the queries touch (K1: 4 float32
    cells under each foot in each substep; K2: one bf16 cell a nearest
    sample, 4 float32 cells a bilinear one);
  * operations: the plain version's, as PyTorch's dispatcher sees them
    (an elementwise op one an output element, a reduction one an input
    element, a product 2*M*N*K, data movement none); the Philox draws
    PHILOX_OPS a value.
A count does not depend on how the kernel computes: a later kernel that
reads less than its inputs (from L2, say) can read above 100%, which the
harness reports as it reads it.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3 (data sheet)
PEAK_F32_OPS_S = 67e12        # H100 SXM float32 off the tensor cores
PEAK_BF16_FLOPS_S = 989e12    # H100 SXM dense bf16 tensor cores
# Philox4x32-10 per output value: 10 rounds of 2 multiply-high, 2 multiply-
# low and 4 XORs, 9 pairs of key additions, per 4 values; then a shift, a
# conversion, a multiply and a subtraction
PHILOX_OPS = (10 * 8 + 9 * 2) / 4 + 4

# kernel -> (wrapper in the port, the symbol of its CUDA kernel as the
# profiler names it; each lies in an anonymous namespace of csrc/)
KERNELS = {
    "K1": ("physics/cuda_substep.py decimation_step", "substep_kernel"),
    "K2": ("terrain/cuda_sampler.py sample_all", "sample_all_kernel"),
    "K3": ("env/cuda_planner.py select_footholds", "plan_kernel"),
    "K4": ("ops/cuda_patch.py extract_patches", "copy_rows_kernel"),
    "K6": ("env/cuda_rewards.py compute_rewards_fused", "rewards_kernel"),
    "K7": ("env/cuda_obs.py compute_observations_fused", "obs_kernel"),
    "K8": ("ops/cuda_rng.py uniform_pm1", "uniform_kernel"),
    "K9": ("ops/cuda_gather.py permute_groups", "gather_kernel"),
}

TABLE = Path(__file__).resolve().parent / "kernels.json"
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def table() -> dict:
    return json.loads(TABLE.read_text())


def _launch_shapes(cfg: dict) -> tuple:
    """What a launch's counts follow: the task (the env's kernels), the
    rollout's length and the algorithm (the update's gather, which every
    policy but the recurrent one, launching none, lays out alike)."""
    train = cfg["train"]
    return (cfg["task"], train["runner"]["num_steps_per_env"],
            train["algorithm"])


def for_config(name: str, cfg: dict) -> dict | None:
    """The counts of configuration `name` (its file's data `cfg`): its own
    entry, else that of a configuration of the table with the same task,
    rollout length and algorithm (another policy on a task the table
    holds); None where none matches."""
    t = table()
    if name in t:
        return t[name]
    for other, counts in t.items():
        path = CONFIGS / f"{other}.json"
        if path.is_file() and _launch_shapes(
                json.loads(path.read_text())) == _launch_shapes(cfg):
            return counts
    return None


def launch(counts: dict, num_envs: int) -> dict:
    """read, written, ops of one launch at num_envs envs."""
    return {k: a + b * num_envs for k, (a, b) in counts.items()}


def bound_s(read: float, written: float, ops: float) -> float:
    """The least time of a launch: the larger of its bytes over the memory
    rate and its operations over the float32 rate."""
    return max((read + written) / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)
