"""Stepping-stone evaluation: tracking error and fall rate on the headline
DTC terrain.

    python -m deep_tracking_control_tpu_torch.scripts.eval_stones
        --task lite3_dtc --log_root logs [--num_envs 64] [--steps 1500]
        [--difficulty 0.45] [--device cpu]

Builds a selected-terrain world (every tile stepping stones of size
1.05 - difficulty, 2 m pits, 3x3 tiles, 8 m border; terrain seed = seed
+ 7), loads the latest checkpoint, rolls the deterministic teacher policy
(DTC_EVAL_RAW_LT=1: the training input layout) and reports, as the JAX
package's scripts/eval_stones.py does:
  * mean and p90 |v_cmd - v| tracking error (xy) over all steps;
  * fall rate: non-timeout terminations per ended episode;
  * mean episode length.
The per-step errors and flags stay on the device through the rollout
and are fetched once after it.
"""
import dataclasses
import time

import numpy as np
import torch

from . import common

NUM_ENVS, STEPS, DIFFICULTY = 64, 1500, 0.45


def stone_size(difficulty: float) -> float:
    return 1.0 * (1.05 - difficulty)


def configure(task_cfg, train_cfg, num_envs: int = NUM_ENVS,
              difficulty: float = DIFFICULTY):
    """The stepping-stone selected world at a fixed difficulty; no noise,
    pushes or friction randomization; random eval commands."""
    task_cfg = dataclasses.replace(
        task_cfg,
        env=dataclasses.replace(task_cfg.env, num_envs=num_envs,
                                play_command=False),
        terrain=dataclasses.replace(
            task_cfg.terrain, num_rows=3, num_cols=3, curriculum=False,
            border_size=8.0, selected=True,
            selected_terrain_type="stepping_stones_terrain",
            selected_terrain_kwargs=(
                ("stone_size", stone_size(difficulty)),
                ("stone_distance", 0.06),
                ("max_height", 0.0),
                ("platform_size", 1.0),
                ("depth", -2.0),
            )),
        noise=dataclasses.replace(task_cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(task_cfg.domain_rand,
                                        push_robots=False,
                                        randomize_friction=False),
    )
    return task_cfg, train_cfg


def setup(args, num_envs=None, difficulty=DIFFICULTY, transform=None):
    """(env, runner, policy) on the stepping-stone world, the checkpoint
    loaded."""
    num_envs = num_envs or getattr(args, "num_envs", None) or NUM_ENVS
    task_cfg, train_cfg = configure(*common.task_cfgs(args, transform),
                                    num_envs=num_envs, difficulty=difficulty)
    runner = common.policy_runner(args, task_cfg, train_cfg,
                                  terrain_seed=train_cfg.runner.seed + 7)
    return runner.env, runner, common.eval_policy(runner)


@torch.no_grad()
def rollout(env, params, state, policy, generator, steps, draws=None):
    """`steps` policy steps.  Returns (state, errs, falls, dones): each
    (steps, N) on the device — the xy tracking error |v_cmd - v| after
    each step (base_vel un-scaled by the task's lin_vel obs scale), the
    non-timeout terminations and the terminations."""
    scale = env.cfg.normalization.obs_scales.lin_vel
    errs, falls, dones = [], [], []
    for i in range(steps):
        a = policy(state["obs"], state["obs_history"],
                   state["privileged_obs"])
        state, out = env.step(params, state, a, generator,
                              draws=common.step_draws(draws, i))
        errs.append(torch.linalg.vector_norm(
            state["commands"][:, :2] - out["base_vel"][:, :2] / scale,
            dim=1))
        falls.append(out["done"] & ~out["time_out"])
        dones.append(out["done"])
    return (state, torch.stack(errs), torch.stack(falls),
            torch.stack(dones))


def report(errs, falls, dones, difficulty=DIFFICULTY):
    """The JAX script's report dict from the rollout's (steps, N)
    tensors (fetched here), printed a key a line."""
    errs = errs.cpu().numpy()
    falls = falls.cpu().numpy()
    dones = dones.cpu().numpy()
    steps, N = errs.shape
    n_falls = falls.sum()
    n_eps = max(dones.sum(), 1)
    report = {
        "terrain": f"stepping_stones(difficulty={difficulty}, "
                   f"stone={stone_size(difficulty):.2f}m)",
        "envs": N, "steps": steps,
        "tracking_err_xy_mean_mps": float(errs.mean()),
        "tracking_err_xy_p90_mps": float(np.quantile(errs, 0.9)),
        "fall_rate_per_episode": float(n_falls / n_eps),
        "falls": int(n_falls), "episodes": int(dones.sum()),
        "mean_episode_length": float(steps * N / max(dones.sum(), 1)),
    }
    for k, v in report.items():
        print(f"{k}: {v}", flush=True)
    return report


def evaluate(args, num_envs=None, steps=None, difficulty=DIFFICULTY,
             transform=None):
    steps = steps or getattr(args, "steps", None) or STEPS
    env, runner, policy = setup(args, num_envs, difficulty, transform)
    t0 = time.perf_counter()
    _, errs, falls, dones = rollout(
        env, runner.env_params, runner.env_state, policy,
        torch.Generator(env.device).manual_seed(42), steps)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    wall = time.perf_counter() - t0
    out = report(errs, falls, dones, difficulty)
    print(f"env_steps_per_s: {steps * env.num_envs / wall:.1f}", flush=True)
    return out


def main(argv=None):
    args = common.parse_args(argv, extra=(
        (["--steps"], dict(type=int, default=STEPS)),
        (["--difficulty"], dict(type=float, default=DIFFICULTY)),
    ))
    return evaluate(args, difficulty=args.difficulty)


if __name__ == "__main__":
    main()
