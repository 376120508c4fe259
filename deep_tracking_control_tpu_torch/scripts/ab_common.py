"""What the two A/B scripts (ab_granule, ab_fused_step) share: a short
lite3_dtc training run of one variant of the update, at `terrain_seed=1`
with the episode lengths drawn at random first, its curve of
Train/mean_reward and Train/mean_episode_length, and the table that sets
two variants side by side.

The runner logs (and so adds a curve point) every LOG_INTERVAL-th
iteration, and only with a log directory: each run logs under a
temporary directory of its own, removed when it ends.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

from ..env.legged_env import LeggedEnv
from ..runner.train import OnPolicyRunner
from ..tasks.registry import get_cfgs
from .common import check_device

TASK = "lite3_dtc"
TERRAIN_SEED = 1
CURVES = ("Train/mean_reward", "Train/mean_episode_length")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    check_device(args.device)
    return args


def variant_cfgs(num_envs: int, seed: int, **algorithm):
    """lite3_dtc's configs at `num_envs` envs and runner seed `seed`, with
    the AlgorithmCfg fields `algorithm` replaced."""
    task_cfg, train_cfg = get_cfgs(TASK)
    task_cfg = dataclasses.replace(
        task_cfg, env=dataclasses.replace(task_cfg.env, num_envs=num_envs))
    train_cfg = dataclasses.replace(
        train_cfg,
        runner=dataclasses.replace(train_cfg.runner, seed=seed),
        algorithm=dataclasses.replace(train_cfg.algorithm, **algorithm))
    return task_cfg, train_cfg


class Recorder:
    """A writer that keeps the two curves, {iteration: value} each."""

    def __init__(self):
        self.rew, self.len = {}, {}

    def add_scalar(self, k, v, it):
        if k == CURVES[0]:
            self.rew[it] = v
        elif k == CURVES[1]:
            self.len[it] = v


def variant_runner(task_cfg, train_cfg, device, log_dir, writer):
    """The variant's env (at TERRAIN_SEED) and runner on `device`."""
    env = LeggedEnv(task_cfg, terrain_seed=TERRAIN_SEED,
                    device=check_device(device))
    return OnPolicyRunner(env, train_cfg, log_dir=log_dir, writer=writer)


def run_variant(task_cfg, train_cfg, iters: int, device: str = "cuda"):
    """learn(iters) with the episode lengths drawn at random first:
    (rew curve, len curve, wall seconds of learn)."""
    rec = Recorder()
    with tempfile.TemporaryDirectory(prefix="ab_") as log_dir:
        runner = variant_runner(task_cfg, train_cfg, device, log_dir, rec)
        t0 = time.time()
        runner.learn(iters, init_at_random_ep_len=True)
        dt = time.time() - t0
    return rec.rew, rec.len, dt


def report(a, b, label_a: str, label_b: str, faster: str):
    """The curves of two variants' `run_variant` results side by side, the
    wall line and the last common iteration's rewards."""
    ra, la, ta = a
    rb, lb, tb = b
    print(f"\n{'it':>6s} {'rew ' + label_a:>10s} {'rew ' + label_b:>10s} "
          f"{'len ' + label_a:>10s} {'len ' + label_b:>10s}", flush=True)
    its = sorted(set(ra) & set(rb))
    for it in its:
        print(f"{it:6d} {ra[it]:10.3f} {rb[it]:10.3f} "
              f"{la.get(it, float('nan')):10.1f} "
              f"{lb.get(it, float('nan')):10.1f}", flush=True)
    print(f"\nwall: {label_a} {ta:.1f}s  {label_b} {tb:.1f}s "
          f"({(ta - tb) / max(ta, 1e-9) * 100:+.1f}% faster {faster})",
          flush=True)
    final = its[-1]
    print(f"final rewards: {label_a} {ra[final]:.3f} vs {label_b} "
          f"{rb[final]:.3f}", flush=True)
