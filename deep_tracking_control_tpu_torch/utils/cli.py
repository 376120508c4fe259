"""CLI argument handling (helpers.py:97-148 parity, argparse-native).

A copy of the JAX package's framework-free utils/cli.py (this package
imports nothing of it); tests/test_torch_copies.py holds the two equal.
"""
from __future__ import annotations

import argparse
import dataclasses


def get_args(argv=None, extra=()):
    """Flag set mirroring get_args (helpers.py:122-148).

    extra: optional [(args_list, kwargs_dict), ...] of script-specific
    flags (e.g. scripts/teleop.py --zero_policy)."""
    p = argparse.ArgumentParser(description="RL Policy (TPU-native DTC)")
    p.add_argument("--task", type=str, default="lite3_dtc")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--load_run", type=str, default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--headless", action="store_true", default=True)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--log_root", type=str, default="logs")
    p.add_argument("--debug_viz", action="store_true", default=False)
    # headless viewer replacement: record env 0 and write an animated GIF
    # (the Isaac viewer + foothold debug spheres have no TPU analog;
    # base_task.py:130-190, legged_robot_dtc.py:460-520)
    p.add_argument("--render", action="store_true", default=False)
    p.add_argument("--render_path", type=str, default="render.gif")
    p.add_argument("--render_steps", type=int, default=300)
    # full 3D scene (terrain surface + FK-posed robot skeleton + foothold
    # markers, utils/viewer3d.py) instead of the top-down panel
    p.add_argument("--render3d", action="store_true", default=False)
    for a, kw in extra:
        p.add_argument(*a, **kw)
    return p.parse_args(argv)


def update_cfg_from_args(task_cfg, train_cfg, args):
    """CLI overrides (update_cfg_from_args, helpers.py:97-120)."""
    if args.num_envs is not None:
        task_cfg = dataclasses.replace(
            task_cfg, env=dataclasses.replace(task_cfg.env,
                                              num_envs=args.num_envs))
    runner = train_cfg.runner
    if args.seed is not None:
        runner = dataclasses.replace(runner, seed=args.seed)
    if args.max_iterations is not None:
        runner = dataclasses.replace(runner, max_iterations=args.max_iterations)
    if args.resume:
        runner = dataclasses.replace(runner, resume=True)
    if args.experiment_name is not None:
        runner = dataclasses.replace(runner, experiment_name=args.experiment_name)
    if args.run_name is not None:
        runner = dataclasses.replace(runner, run_name=args.run_name)
    if args.load_run is not None:
        runner = dataclasses.replace(runner, load_run=args.load_run)
    if args.checkpoint is not None:
        runner = dataclasses.replace(runner, checkpoint=args.checkpoint)
    train_cfg = dataclasses.replace(train_cfg, runner=runner)
    return task_cfg, train_cfg
