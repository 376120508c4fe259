"""Policy evaluation (legged_gym/scripts/play.py parity, headless).

    python -m deep_tracking_control_tpu_torch.scripts.play --task lite3_dtc
        [--log_root logs] [--render [--render3d]] [--device cpu]

Loads the latest checkpoint, overrides the config for evaluation (at most
100 envs, no noise / pushes / friction randomization / curriculum, random
eval commands, the stepping-stone-heavy terrain mix, `debug_viz` on —
play.py:17-41), rolls the deterministic teacher policy on the card (the
CPU with --device cpu), and prints commanded-vs-actual velocity and
height of env 0 every 10 steps.  Every 100 steps it writes a foothold
debug PNG into the temporary directory (when matplotlib is installed);
--render records env 0 and writes a top-down GIF (with --render3d the
3D scene).
With `debug_viz` the env takes the plain foothold planner (it returns the
score tensor the debug frames draw), so a step launches no planner
kernel.
"""
import dataclasses
import importlib.util
import os
import tempfile
import time

import torch

from . import common

STEPS = 1000


def configure(task_cfg, train_cfg):
    """Eval overrides (play.py:17-36): <=100 envs, 3x3 grid, curriculum /
    noise / pushes / friction-rand off, random eval commands
    (play_command=False), debug_viz on (play.py:41), and the
    stepping-stone-heavy terrain mix."""
    task_cfg = dataclasses.replace(
        task_cfg,
        env=dataclasses.replace(task_cfg.env,
                                num_envs=min(task_cfg.env.num_envs, 100),
                                play_command=False, debug_viz=True),
        terrain=dataclasses.replace(
            task_cfg.terrain, num_rows=3, num_cols=3,
            curriculum=False, border_size=8.0,
            terrain_proportions=(0.0, 0.0, 0.0, 0.0, 0.0, 0.2, 0.0, 0.0)),
        noise=dataclasses.replace(task_cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(task_cfg.domain_rand,
                                        push_robots=False,
                                        randomize_friction=False),
    )
    return task_cfg, train_cfg


def setup(args, transform=None):
    """(env, runner, policy) with the checkpoint loaded."""
    task_cfg, train_cfg = configure(*common.task_cfgs(args, transform))
    runner = common.policy_runner(args, task_cfg, train_cfg,
                                  terrain_seed=train_cfg.runner.seed)
    return runner.env, runner, runner.get_inference_policy(teacher=True)


def _frame(state, out, lin_vel_scale):
    """Env 0's render frame, on the device."""
    d = out["debug"]
    return dict(base_pos=state["phys"]["pos"][:, 0],
                base_quat=state["phys"]["quat"][:, 0],
                q=state["phys"]["q"][:, 0],
                foot_positions=d["foot_positions"][0],
                pred_footholds=d["pred_footholds"][0],
                optimal_footholds=state["optimal_footholds_world"][0],
                commands=state["commands"][0],
                base_vel=out["base_vel"][0] / lin_vel_scale)


@torch.no_grad()
def rollout(env, params, state, policy, generator, steps, draws=None,
            record_steps=0, png_dir=None):
    """`steps` policy steps; prints env 0's command, velocity and height
    every 10 steps (the only reads from the device in the loop) and, every
    100, writes a foothold debug PNG into png_dir (None: none).  Returns
    (state, frames): env 0's render frames of the first `record_steps`
    steps as numpy arrays, fetched after the loop."""
    scale = env.cfg.normalization.obs_scales.lin_vel
    frames = []
    for i in range(steps):
        actions = policy(state["obs"], state["obs_history"],
                         state["privileged_obs"])
        state, out = env.step(params, state, actions, generator,
                              draws=common.step_draws(draws, i))
        if "debug" in out and i < record_steps:
            frames.append({k: v.clone()
                           for k, v in _frame(state, out, scale).items()})
        if i % 10 == 0:
            cmd = state["commands"][0, :2].cpu().numpy()
            vel = (out["base_vel"][0, :2] / scale).cpu().numpy()
            z = float(state["phys"]["pos"][2, 0])
            print(f"step {i:5d} cmd=({cmd[0]:+.2f},{cmd[1]:+.2f}) "
                  f"vel=({vel[0]:+.2f},{vel[1]:+.2f}) z={z:+.3f}",
                  flush=True)
            if "debug" in out and i % 100 == 0 and png_dir is not None:
                debug_png(os.path.join(png_dir, f"dtc_debug_{i:05d}.png"),
                          env, state, out)
    return state, [{k: v.cpu().numpy() for k, v in f.items()}
                   for f in frames]


def debug_png(path, env, state, out):
    """Env 0's foothold debug frame (utils/debug_viz.py)."""
    from ..utils.debug_viz import draw_foothold_debug
    d = out["debug"]
    return draw_foothold_debug(
        path, env.grid.height.cpu().numpy(), env.grid.horizontal_scale,
        env.grid.border_size, state["phys"]["pos"][:, 0].cpu().numpy(),
        d["heights_world"][0].cpu().numpy(),
        d["foothold_score"][0].cpu().numpy(),
        d["pred_footholds"][0].cpu().numpy(),
        state["optimal_footholds_world"][0].cpu().numpy(),
        d["foot_positions"][0].cpu().numpy())


def render(args, env, frames):
    """Write the recorded frames as a GIF: the 3D scene with --render3d,
    else the top-down panel.  Returns the written path."""
    height = env.grid.height.cpu().numpy()
    grid = env.grid
    if getattr(args, "render3d", False):
        from ..utils.viewer3d import render_3d_animation
        return render_3d_animation(
            args.render_path, height, grid.horizontal_scale,
            grid.border_size, env.model, frames,
            title=f"{args.task} 3D gait")
    from ..utils.render_anim import render_gait_animation
    return render_gait_animation(
        args.render_path, height, grid.horizontal_scale, grid.border_size,
        frames, stride=2, title=f"{args.task} gait")


def play(args, steps: int = STEPS, transform=None, png_dir=None):
    env, runner, policy = setup(args, transform)
    record = args.render_steps if getattr(args, "render", False) else 0
    t0 = time.perf_counter()
    _, frames = rollout(env, runner.env_params, runner.env_state, policy,
                        torch.Generator(env.device).manual_seed(123), steps,
                        record_steps=record, png_dir=png_dir)
    wall = time.perf_counter() - t0
    print(f"{steps} steps x {env.num_envs} envs in {wall:.2f} s: "
          f"{steps * env.num_envs / wall:.1f} env-steps/s", flush=True)
    if frames:
        out_path = render(args, env, frames)
        print(f"Wrote animation to {out_path} ({len(frames)} frames)")
    return frames


def main(argv=None):
    args = common.parse_args(argv)
    png_dir = None
    if importlib.util.find_spec("matplotlib") is not None:
        png_dir = tempfile.gettempdir()
    else:
        print("matplotlib is not installed: no foothold debug PNGs")
    return play(args, png_dir=png_dir)


if __name__ == "__main__":
    main()
