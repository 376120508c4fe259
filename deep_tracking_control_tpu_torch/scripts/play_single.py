"""Single-robot evaluation (legged_gym/scripts/play_single.py parity).

    python -m deep_tracking_control_tpu_torch.scripts.play_single
        --task lite3_dtc [--log_root logs] [--device cpu]

One env, the fixed play command, commanded-vs-actual telemetry of every
step and a state log (utils/logger.py) printed at the end.  The step
values stay on the device through the rollout and are fetched once after
it.
"""
import dataclasses
import time

import torch

from ..utils.logger import Logger
from . import common

STEPS = 500


def configure(task_cfg, train_cfg):
    """One env, play_command, a 1x1 world without curriculum, no noise
    or pushes."""
    task_cfg = dataclasses.replace(
        task_cfg,
        env=dataclasses.replace(task_cfg.env, num_envs=1, play_command=True),
        terrain=dataclasses.replace(task_cfg.terrain, num_rows=1, num_cols=1,
                                    curriculum=False, border_size=8.0),
        noise=dataclasses.replace(task_cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(task_cfg.domain_rand,
                                        push_robots=False))
    return task_cfg, train_cfg


def setup(args, transform=None):
    """(env, runner, policy) with the checkpoint loaded."""
    task_cfg, train_cfg = configure(*common.task_cfgs(args, transform))
    runner = common.policy_runner(args, task_cfg, train_cfg,
                                  terrain_seed=train_cfg.runner.seed)
    return runner.env, runner, runner.get_inference_policy(teacher=True)


@torch.no_grad()
def rollout(env, params, state, policy, generator, steps, draws=None):
    """`steps` policy steps of env 0.  Returns (state, log): (steps, 3)
    numpy rows of the commanded x velocity, the x velocity and the base
    height after each step, fetched after the loop."""
    rows = []
    for i in range(steps):
        actions = policy(state["obs"], state["obs_history"],
                         state["privileged_obs"])
        state, out = env.step(params, state, actions, generator,
                              draws=common.step_draws(draws, i))
        # the velocity scale is 2.0, as the JAX script writes it
        rows.append(torch.stack([state["commands"][0, 0],
                                 out["base_vel"][0, 0] / 2.0,
                                 state["phys"]["pos"][2, 0]]))
    return state, torch.stack(rows).cpu().numpy()


def report(task_cfg, log):
    """Print each step's line and the logger's summary; returns the
    Logger."""
    logger = Logger(task_cfg.dt)
    for i, (cmd_x, vel_x, z) in enumerate(log):
        logger.log_states(dict(cmd_x=cmd_x, vel_x=vel_x, base_z=z))
        print(f"step {i:5d} cmd_x={cmd_x:+.2f} vel_x={vel_x:+.2f} z={z:+.3f}")
    logger.print_rewards()
    return logger


def play_single(args, steps: int = STEPS, transform=None):
    env, runner, policy = setup(args, transform)
    t0 = time.perf_counter()
    _, log = rollout(env, runner.env_params, runner.env_state, policy,
                     torch.Generator(env.device).manual_seed(7), steps)
    wall = time.perf_counter() - t0
    logger = report(env.cfg, log)
    print(f"{steps} steps in {wall:.2f} s: {steps / wall:.1f} env-steps/s",
          flush=True)
    return logger


def main(argv=None):
    return play_single(common.parse_args(argv))


if __name__ == "__main__":
    main()
