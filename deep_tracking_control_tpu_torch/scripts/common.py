"""What the evaluation entry points share: the task's configs with the
CLI's overrides, the device check, and a runner that holds a trained
policy (its latest checkpoint loaded without the optimizers).

Each script (play, play_single, play_plane, eval_stones,
analyze_terminations, teleop) is split into its config override
(`configure`), its set-up (`setup`: env, runner, checkpoint, policy), its
rollout and its report, so the tests and chip_smoke.py drive the code
the command line runs.  The rollouts take per-step `draws` (a list of the
env step's injected draws, one dict a step) so the CPU tests can feed the
JAX package's draws.
"""
from __future__ import annotations

import os

import torch

from ..env.legged_env import LeggedEnv
from ..runner import checkpoint as ckpt
from ..runner.train import OnPolicyRunner
from ..tasks.registry import get_cfgs
from ..utils.cli import get_args, update_cfg_from_args
from .train import DEVICE_ARG


def parse_args(argv=None, extra=()):
    """The shared flags (utils/cli.py), `--device` and the script's own."""
    return get_args(argv, extra=tuple(DEVICE_ARG) + tuple(extra))


def task_cfgs(args, transform=None):
    """The task's configs with the CLI's overrides; `transform(task_cfg,
    train_cfg) -> (task_cfg, train_cfg)` applies before the script's own
    overrides (play_plane's plane; the tests' small sizes)."""
    task_cfg, train_cfg = get_cfgs(args.task)
    task_cfg, train_cfg = update_cfg_from_args(task_cfg, train_cfg, args)
    if transform is not None:
        task_cfg, train_cfg = transform(task_cfg, train_cfg)
    return task_cfg, train_cfg


def check_device(device: str) -> str:
    """The script's device; on "cuda" without a card it stops (no script
    carries on on the CPU unasked)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    return device


def policy_runner(args, task_cfg, train_cfg, terrain_seed: int,
                  load: bool = True):
    """LeggedEnv + OnPolicyRunner on args.device; with `load`, the latest
    checkpoint under <log_root>/<experiment_name> (or --load_run /
    --checkpoint) loaded with load_optimizer=False."""
    env = LeggedEnv(task_cfg, terrain_seed=terrain_seed,
                    device=check_device(args.device))
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    if load:
        root = os.path.join(args.log_root, train_cfg.runner.experiment_name)
        path = ckpt.get_load_path(root, train_cfg.runner.load_run,
                                  train_cfg.runner.checkpoint)
        print(f"Loading policy from {path}", flush=True)
        runner.load(path, load_optimizer=False)
    return runner


def eval_policy(runner):
    """The teacher policy (act_teacher), or with DTC_EVAL_RAW_LT=1 the
    training input layout (act_deterministic: raw l_t), as the JAX eval
    scripts read it."""
    return runner.get_inference_policy(
        teacher=os.environ.get("DTC_EVAL_RAW_LT", "0") != "1")


def step_draws(draws, i):
    """Step i's injected draws, or None."""
    return None if draws is None else draws[i]
