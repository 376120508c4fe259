"""Per-cause / per-terrain termination analysis for a trained policy.

    python -m deep_tracking_control_tpu_torch.scripts.analyze_terminations
        --task x30_dtc --log_root logs [--num_envs 256] [--steps 2000]
        [--level L] [--device cpu]

Answers "what ends episodes early?": rolls the deterministic teacher
policy (DTC_EVAL_RAW_LT=1: the training input layout) on the training
curriculum world (terrain seed = seed + 3) and tallies, per termination
cause (torso contact force, gravity flip, height below the terrain,
timeout — check_termination parity, legged_robot_dtc.py:229-245) and per
terrain level and column, how episodes end.  --level L pins every env to
curriculum level L (else the levels are mixed); the levels are frozen
every step so that each ending is counted at the level it was played on.
The tallies accumulate on the device and are fetched once at the end.
"""
import dataclasses
import time

import torch

from ..terrain.generator import column_families
from . import common

NUM_ENVS, STEPS = 256, 2000
CAUSES = ("term_contact", "term_gravity", "term_height", "term_timeout")


def configure(task_cfg, train_cfg, num_envs: int = NUM_ENVS,
              level: int = -1):
    """The curriculum world, started at level `level` (or at every level
    up to the last when level < 0); no noise or pushes; random eval
    commands."""
    task_cfg = dataclasses.replace(
        task_cfg,
        env=dataclasses.replace(task_cfg.env, num_envs=num_envs,
                                play_command=False),
        terrain=dataclasses.replace(task_cfg.terrain, curriculum=True,
                                    max_init_terrain_level=(
                                        level if level >= 0
                                        else task_cfg.terrain.num_rows - 1)),
        noise=dataclasses.replace(task_cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(task_cfg.domain_rand,
                                        push_robots=False),
    )
    return task_cfg, train_cfg


def setup(args, transform=None):
    """(env, runner, policy) with the checkpoint loaded and, with --level,
    every env's level pinned."""
    N = args.num_envs or NUM_ENVS
    task_cfg, train_cfg = configure(*common.task_cfgs(args, transform),
                                    num_envs=N, level=args.level)
    runner = common.policy_runner(args, task_cfg, train_cfg,
                                  terrain_seed=train_cfg.runner.seed + 3)
    if args.level >= 0:
        levels = torch.full_like(runner.env_state["terrain_levels"],
                                 args.level)
        runner.env_state = {**runner.env_state, "terrain_levels": levels}
    return runner.env, runner, common.eval_policy(runner)


@torch.no_grad()
def rollout(env, params, state, policy, generator, steps, draws=None):
    """`steps` policy steps with the curriculum frozen.  Returns (state,
    stats): on the device, summed over the steps — the live-step count,
    the ended episodes, each cause's count, and the ended and non-timeout
    endings by level (num_rows) and by column (num_cols)."""
    dev = env.device
    rows = torch.arange(env.cfg.terrain.num_rows, device=dev)
    cols = torch.arange(env.cfg.terrain.num_cols, device=dev)
    stats = {}
    for i in range(steps):
        a = policy(state["obs"], state["obs_history"],
                   state["privileged_obs"])
        # freeze the curriculum so per-level attribution stays stable
        lv = state["terrain_levels"]
        state, out = env.step(params, state, a, generator,
                              draws=common.step_draws(draws, i))
        state = {**state, "terrain_levels": lv}
        m = out["metrics"]
        done = out["done"]
        onehot_lvl = (lv[:, None] == rows).float()
        onehot_typ = (state["terrain_types"][:, None] == cols).float()
        dn = done.float()
        non_to = (done & ~out["time_out"]).float()
        step = dict(
            ep_len_sum=(1.0 - dn).sum(),       # live-step count
            n_done=m["n_done"], **{c: m[c] for c in CAUSES},
            done_by_level=(dn[:, None] * onehot_lvl).sum(0),
            fall_by_level=(non_to[:, None] * onehot_lvl).sum(0),
            done_by_type=(dn[:, None] * onehot_typ).sum(0),
            fall_by_type=(non_to[:, None] * onehot_typ).sum(0))
        stats = ({k: stats[k] + v for k, v in step.items()} if stats
                 else step)
    return state, stats


def report(task, terrain_cfg, stats, N, T, level=-1):
    """Print the tallies (fetched here) as the JAX script does; returns
    them as numbers and lists."""
    stats = {k: v.cpu().numpy() for k, v in stats.items()}
    n_done = max(float(stats["n_done"]), 1.0)
    print(f"\n=== {task} over {N} envs x {T} steps "
          f"(level={'mixed' if level < 0 else level}) ===")
    print(f"episodes ended: {int(stats['n_done'])}   "
          f"mean ep len ~ {N * T / n_done:.0f} steps")
    print("\ncause rates (per ended episode; causes may co-fire):")
    for c in CAUSES:
        print(f"  {c:14s}: {stats[c] / n_done:7.3f}")
    print("\nterminations by terrain level (row = difficulty):")
    for i, (d, f) in enumerate(zip(stats["done_by_level"],
                                   stats["fall_by_level"])):
        if d > 0:
            print(f"  level {i:2d}: ended {int(d):6d}  non-timeout "
                  f"{int(f):6d}  ({100 * f / max(d, 1):.0f}% falls)")
    print("\nterminations by terrain column (type):")
    fam_by_col = column_families(terrain_cfg)
    for i, (d, f) in enumerate(zip(stats["done_by_type"],
                                   stats["fall_by_type"])):
        name = fam_by_col[i]
        if d > 0:
            print(f"  {name:16s}: ended {int(d):6d}  non-timeout "
                  f"{int(f):6d}  ({100 * f / max(d, 1):.0f}% falls)")
    return {k: v.tolist() for k, v in stats.items()}


def analyze(args, transform=None):
    env, runner, policy = setup(args, transform)
    N, T = env.num_envs, args.steps
    t0 = time.perf_counter()
    _, stats = rollout(env, runner.env_params, runner.env_state, policy,
                       torch.Generator(env.device).manual_seed(11), T)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    wall = time.perf_counter() - t0
    out = report(args.task, env.cfg.terrain, stats, N, T, args.level)
    print(f"\n{T} steps x {N} envs in {wall:.2f} s: "
          f"{T * N / wall:.1f} env-steps/s", flush=True)
    return out


def parse_args(argv=None):
    return common.parse_args(argv, extra=(
        (["--steps"], dict(type=int, default=STEPS)),
        (["--level"], dict(type=int, default=-1)),
    ))


def main(argv=None):
    return analyze(parse_args(argv))


if __name__ == "__main__":
    main()
