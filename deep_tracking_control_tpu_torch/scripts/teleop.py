"""Interactive keyboard teleop (the reference viewer's control surface,
headless).

    python -m deep_tracking_control_tpu_torch.scripts.teleop
        --task lite3_dtc --log_root logs [--num_envs 4] [--device cpu]
    python -m deep_tracking_control_tpu_torch.scripts.teleop
        --task lite3_dtc --zero_policy        # no checkpoint

Drives a trained policy live from the terminal with the reference's key
bindings (base_task.py:63-95,130-190): W/S vx, A/D vy, Q/E turn, R reset,
P/N or 0-8 switch the looked-at env, ESC/x quit.  Renders a curses panel:
telemetry + a top-down ASCII heightfield with base/feet/foothold markers
(the headless analog of _draw_debug_vis, legged_robot_dtc.py:460-520).
The core is utils/teleop.py `TeleopSession`.
"""
import curses
import dataclasses
import time

import torch

from ..utils.teleop import TeleopSession
from . import common

NUM_ENVS = 4


def configure(task_cfg, train_cfg, num_envs: int = NUM_ENVS):
    """Eval overrides as in play.py, plus: commands never resample
    mid-episode (the keyboard owns them) and debug_viz on for the
    foothold markers; at most 9 envs (keys 0-8)."""
    task_cfg = dataclasses.replace(
        task_cfg,
        env=dataclasses.replace(task_cfg.env, num_envs=min(num_envs, 9),
                                play_command=False, debug_viz=True),
        commands=dataclasses.replace(task_cfg.commands,
                                     resampling_time=1e6),
        terrain=dataclasses.replace(
            task_cfg.terrain, num_rows=3, num_cols=3,
            curriculum=False, border_size=8.0),
        noise=dataclasses.replace(task_cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(task_cfg.domain_rand,
                                        push_robots=False,
                                        randomize_friction=False),
    )
    return task_cfg, train_cfg


def build(args, transform=None):
    """A TeleopSession over the loaded policy (a recurrent one carries its
    hidden state from step to step), or with --zero_policy over zero
    actions (no checkpoint needed)."""
    zero = getattr(args, "zero_policy", False)
    task_cfg, train_cfg = configure(
        *common.task_cfgs(args, transform),
        num_envs=getattr(args, "num_envs", None) or NUM_ENVS)
    runner = common.policy_runner(args, task_cfg, train_cfg,
                                  terrain_seed=train_cfg.runner.seed,
                                  load=not zero)
    env = runner.env
    if zero:
        def policy(obs, obs_history, privileged_obs):
            return torch.zeros((env.num_envs, env.num_actions),
                               device=env.device)
    elif runner.recurrent:
        # the carry-threading policy (obs, (ca, cc)) -> (actions, (ca, cc))
        # behind the session's (obs, obs_history, privileged_obs) call
        raw = runner.get_inference_policy()
        carry = [(runner.init_carry(env.num_envs),
                  runner.init_carry(env.num_envs))]

        def policy(obs, obs_history, privileged_obs):
            actions, carry[0] = raw(obs, carry[0])
            return actions
    else:
        policy = runner.get_inference_policy(teacher=True)
    return TeleopSession(env, runner.env_params, runner.env_state, policy,
                         torch.Generator(env.device).manual_seed(1),
                         lin_vel_scale=task_cfg.normalization.obs_scales
                         .lin_vel)


HELP = "W/S vx  A/D vy  Q/E turn  R reset  P/N/0-8 env  ESC quit"


def ui(stdscr, sess):
    curses.curs_set(0)
    stdscr.nodelay(True)
    hz, t_last = 0.0, time.time()
    while True:
        ch = stdscr.getch()
        while ch != -1:                      # drain the key queue
            if not sess.handle_key(ch):
                return
            ch = stdscr.getch()
        tel = sess.step()
        now = time.time()
        hz = 0.9 * hz + 0.1 / max(now - t_last, 1e-6)
        t_last = now

        stdscr.erase()
        c = tel["cmd"]
        stdscr.addstr(0, 0, f"env {tel['lookat']}  {hz:5.1f} Hz   {HELP}")
        stdscr.addstr(
            1, 0,
            f"cmd vx={c[0]:+.2f} vy={c[1]:+.2f} yaw={c[2]:+.2f} "
            f"hdg={c[3]:+.2f} | vel=({tel['vel'][0]:+.2f},"
            f"{tel['vel'][1]:+.2f}) m/s  z={tel['z']:+.3f} m")
        feet = "".join("#" if b else "." for b in tel["contacts"])
        stdscr.addstr(2, 0, f"feet[{feet}]  rew={tel['rew']:+.3f}  "
                            f"len={tel['ep_len']:4d}"
                            f"{'  RESET' if tel['done'] else ''}")
        maxy, maxx = stdscr.getmaxyx()
        rows = max(min(maxy - 5, 31), 5)
        cols = max(min(maxx - 2, 71), 11)
        for r, line in enumerate(sess.ascii_map(rows, cols)):
            if 4 + r >= maxy - 1:
                break
            stdscr.addstr(4 + r, 0, line[:maxx - 1])
        stdscr.refresh()


def parse_args(argv=None):
    return common.parse_args(argv, extra=(
        (["--zero_policy"], dict(action="store_true",
                                 help="drive with zero actions (no ckpt)")),
    ))


def main(argv=None):
    sess = build(parse_args(argv))
    sess.step()  # the first step builds the kernels: before the UI
    curses.wrapper(ui, sess)
    print("teleop ended")


if __name__ == "__main__":
    main()
