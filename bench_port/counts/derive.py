"""Write bench_port/counts/kernels.json: each kernel's bytes and operations
a launch, a + b * N over N envs, for every configuration file.

    python bench_port/counts/derive.py            # rewrite the table
    python bench_port/counts/derive.py --check    # compare, exit 1 if off

Runs on the CPU (about half a minute): the port's env steps at two small env
counts with each kernel wrapper recorded, every launch counted by the
rules of counts/kernels.py, and the update's gather on a collect's batch.
The counts are exact integers at each size; a third size checks that they
are linear.  Only this tool and its test import the port outside a run:
the harness reads the frozen table.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]

from counts import kernels as kc  # noqa: E402
from harness import config as hc  # noqa: E402

SIZES = (16, 32)
CHECK_SIZE = 48

# aten ops that move or make data and compute nothing
_MOVES = {
    "view", "_unsafe_view", "reshape", "expand", "clone", "copy", "_to_copy",
    "cat", "stack", "slice", "select", "index", "index_select", "gather",
    "unsqueeze", "squeeze", "permute", "transpose", "t", "contiguous",
    "alias", "detach", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "fill", "arange",
    "lift_fresh", "split", "split_with_sizes", "unbind", "narrow", "as_strided",
    "new_empty", "new_zeros", "new_full", "scalar_tensor", "_local_scalar_dense",
    "index_put", "scatter", "masked_fill", "repeat", "flip", "roll", "set"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
               "argmin", "any", "all", "norm", "linalg_vector_norm", "var",
               "std", "cumsum", "cumprod", "logsumexp", "sort", "topk"}


def count_ops(fn) -> int:
    """Operations of one fn() call as PyTorch's dispatcher sees them (a
    copy of the port's chip_smoke.py count_ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def numel(x):
        if isinstance(x, torch.Tensor):
            return x.numel()
        if isinstance(x, (tuple, list)):
            return sum(numel(v) for v in x)
        return 0

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ("mm", "addmm"):
                a, b = args[-2], args[-1]
                Counter.ops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
            elif name in ("bmm", "baddbmm"):
                a, b = args[-2], args[-1]
                Counter.ops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            elif name in _REDUCTIONS:
                Counter.ops += numel(args[0])
            elif name not in _MOVES:
                Counter.ops += numel(out)
            return out

    with Counter():
        fn()
    return Counter.ops


def tensor_bytes(tree, skip=()) -> int:
    """Bytes of every tensor in a nest, each counted once; tensors whose id
    is in `skip` (the terrain tables) left out (chip_smoke.py's)."""
    seen, total = set(skip), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return total


def _record(modules):
    """Wrap each (module, function name) so that its first call's
    arguments are kept; returns (calls, undo)."""
    calls, saved = {}, []
    for mod, name in modules:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(*a, _fn=fn, _name=name, **k):
            calls.setdefault(_name, (a, k))
            return _fn(*a, **k)
        setattr(mod, name, rec)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls, undo


def count_at(cfg_file: dict, n: int) -> dict:
    """kernel -> dict(read, written, ops) of one launch at n envs."""
    from deep_tracking_control_tpu_torch.env import (config as pc, cuda_obs,
                                                     cuda_planner, cuda_rewards)
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.ops import cuda_gather, cuda_rng
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    task, train = hc.task_and_train(cfg_file, pc.TaskCfg, pc.TrainCfg, n, 1)
    env = LeggedEnv(task, terrain_seed=1, device="cpu")
    runner = OnPolicyRunner(env, train)
    src = env.patch_src
    tables = {id(src.blocks), id(src.blocks16)}
    calls, undo = _record([
        (cuda_substep, "decimation_step"), (cuda_sampler, "sample_all"),
        (cuda_planner, "select_footholds"),
        (cuda_rewards, "compute_rewards_fused"),
        (cuda_obs, "compute_observations_fused"),
        (cuda_rng, "uniform_pm1"), (cuda_gather, "permute_groups")])
    try:
        runner.learn(1)
    finally:
        undo()
    out = {}

    args, kwargs = calls["decimation_step"]
    kw = {k: v for k, v in kwargs.items() if k != "consts"}
    res = cuda_substep.decimation_step_plain(*args, **kw)
    dec, nenv = args[3], args[6]["pos"].shape[-1]
    out["K1"] = dict(read=tensor_bytes((args, kwargs), tables)
                     + nenv * 4 * dec * 4 * 4,
                     written=tensor_bytes(res),
                     ops=count_ops(lambda: cuda_substep.decimation_step_plain(
                         *args, **kw)))

    args, _ = calls["sample_all"]
    res = cuda_sampler.sample_all_plain(*args)
    near = cuda_sampler.Q_MIN3 + cuda_sampler.Q_MAX10
    out["K2"] = dict(read=tensor_bytes(args, tables)
                     + res[0].shape[0] * (near * 2 + cuda_sampler.Q_BIL * 16),
                     written=tensor_bytes(res),
                     ops=count_ops(lambda: cuda_sampler.sample_all_plain(*args)))

    (scal, heights, stat, ny), _ = calls["select_footholds"]
    res = cuda_planner.plan_plain(scal, heights, stat, ny)
    out["K3"] = dict(read=tensor_bytes((scal, heights, stat)),
                     written=tensor_bytes(res),
                     ops=count_ops(lambda: cuda_planner.plan_plain(
                         scal, heights, stat, ny)))

    args, _ = calls["compute_rewards_fused"]
    *head, sums = args
    scratch = sums.clone()
    rew, upd = cuda_rewards.rewards_plain(*head, scratch.clone())
    out["K6"] = dict(read=tensor_bytes(args),
                     written=tensor_bytes((sums, rew, upd)),
                     ops=count_ops(lambda: cuda_rewards.rewards_plain(
                         *head, scratch)))

    args, _ = calls["compute_observations_fused"]
    seed = args[-1]
    N, H = args[10].shape
    num_obs = args[14].shape[0]
    draws = dict(height_noise=cuda_rng.uniform_pm1_plain(seed, (N, H), 0),
                 obs_noise=cuda_rng.uniform_pm1_plain(seed, (N, num_obs), 1))
    res = cuda_obs.observations_plain(*args, **draws)
    drawn = N * H + (N * num_obs if args[0].noise.add_noise else 0)
    out["K7"] = dict(read=tensor_bytes(args), written=tensor_bytes(res),
                     ops=count_ops(lambda: cuda_obs.observations_plain(
                         *args, **draws)) + kc.PHILOX_OPS * drawn)

    (_, shape), _ = calls["uniform_pm1"]
    numel = shape[0] * shape[1]
    out["K8"] = dict(read=16, written=numel * 4, ops=kc.PHILOX_OPS * numel)

    (flat, perm, G), _ = calls["permute_groups"]
    out["K9"] = dict(read=tensor_bytes(flat) + tensor_bytes(perm),
                     written=tensor_bytes(flat), ops=0)
    return out


def derive(cfg_file: dict) -> dict:
    a, b = (count_at(cfg_file, n) for n in SIZES)
    c = count_at(cfg_file, CHECK_SIZE)
    n0, n1 = SIZES
    table = {}
    for k in a:
        table[k] = {}
        for q in ("read", "written", "ops"):
            slope = (b[k][q] - a[k][q]) / (n1 - n0)
            base = a[k][q] - slope * n0
            if base + slope * CHECK_SIZE != c[k][q]:
                raise ValueError(f"{k} {q}: not linear in the env count "
                                 f"({a[k][q]}, {b[k][q]}, {c[k][q]})")
            table[k][q] = [base, slope]
    return table


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)
    out = {p.stem: derive(hc.load(p))
           for p in sorted((HERE.parent / "configs").glob("*.json"))}
    if args.check:
        same = out == kc.table()
        print("counts match the table" if same else "counts differ")
        sys.exit(0 if same else 1)
    kc.TABLE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
