"""The port's TeleopSession and the evaluation entry points end to end,
on the CPU.

The session: the reference keyboard-control semantics (base_task.py
:141-176) driven headlessly with scripted key events, the four cases of
tests/test_teleop.py on a 4-env lite3_dtc env (debug_viz on, commands
never resampled, zero actions).  The entry points: each script's own
functions (play with its --render GIF and debug PNG, play_single,
play_plane, eval_stones, analyze_terminations, teleop's session) from a
checkpoint that `scripts.train --device cpu` wrote, at the small sizes of
tests/test_torch_eval.py through each script's `transform` argument.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.scripts import (analyze_terminations,
                                                     common, eval_stones,
                                                     play, play_plane,
                                                     play_single, teleop)
from deep_tracking_control_tpu_torch.scripts import train as train_script
from deep_tracking_control_tpu_torch.tasks.registry import get_cfgs
from deep_tracking_control_tpu_torch.utils.teleop import TeleopSession
from tests.test_torch_eval import N, tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the tensors are tiny; parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    cfg, _ = get_cfgs("lite3_dtc")
    cfg = dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, num_envs=4, debug_viz=True),
        commands=dataclasses.replace(cfg.commands, resampling_time=1e6),
        terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2,
                                    border_size=4.0, curriculum=False,
                                    max_init_terrain_level=1),
        noise=dataclasses.replace(cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(cfg.domain_rand,
                                        push_robots=False),
    )
    return LeggedEnv(cfg, terrain_seed=1, device="cpu")


def _session(env):
    params, state = env.init(torch.Generator().manual_seed(0))

    def policy(obs, obs_history, privileged_obs):
        return torch.zeros((env.num_envs, env.num_actions))

    return TeleopSession(env, params, state, policy,
                         torch.Generator().manual_seed(1), lin_vel_scale=2.0)


def test_key_bindings_update_commands(env):
    s = _session(env)
    vx0 = float(s.cmd[0])
    assert s.handle_key(ord("w")) and s.handle_key(ord("w"))
    s.handle_key(ord("s"))
    assert np.isclose(s.cmd[0], vx0 + 0.2), "W/S apply +/-0.2 to vx"
    vy0 = float(s.cmd[1])
    s.handle_key(ord("a"))
    assert np.isclose(s.cmd[1], vy0 + 0.2), "A is +vy (robot-left)"
    # heading mode: Q steers the heading target (col 3)
    h0 = float(s.cmd[3])
    s.handle_key(ord("q"))
    assert s.heading_mode and np.isclose(s.cmd[3], h0 + 0.2)
    # the override lands in env state on step
    tel = s.step()
    assert np.isclose(tel["cmd"][0], vx0 + 0.2)
    assert set(tel) >= {"cmd", "vel", "z", "ep_len", "rew", "contacts",
                        "done", "lookat"}


def test_lookat_switch_and_digit(env):
    s = _session(env)
    s.handle_key(ord("n"))
    assert s.lookat == 1
    s.handle_key(ord("p"))
    s.handle_key(ord("p"))
    assert s.lookat == s.env.num_envs - 1, "P wraps (base_task.py:153)"
    s.handle_key(ord("2"))
    assert s.lookat == 2
    s.handle_key(ord("8"))
    assert s.lookat == s.env.num_envs - 1, "digit clamps to num_envs"


def test_reset_key_resets_only_lookat_env(env):
    s = _session(env)
    for _ in range(3):
        s.step()
    lens = s.state["episode_length"].numpy()
    assert lens.min() >= 3
    s.handle_key(ord("1"))
    s.handle_key(ord("r"))
    lens = s.state["episode_length"].numpy()
    assert lens[1] == 0, "R resets the looked-at env"
    assert lens[0] >= 3 and lens[2] >= 3, "others keep their episodes"


def test_quit_and_ascii_map(env):
    s = _session(env)
    s.step()
    rows = s.ascii_map(rows=11, cols=21)
    assert len(rows) == 11 and all(len(r) == 21 for r in rows)
    assert any("B" in r for r in rows), "base marker present"
    assert not s.handle_key(27) and s.quit, "ESC ends the session"


# ---- the scripts end to end from a checkpoint of scripts.train ------------

@pytest.fixture(scope="module")
def log_root(tmp_path_factory):
    """A checkpoint of `scripts.train --device cpu` (1 iteration, the
    small sizes on a 2x2 world)."""
    root = tmp_path_factory.mktemp("logs")
    task, train = tiny(*get_cfgs("lite3_dtc"))
    task = dataclasses.replace(task, terrain=dataclasses.replace(
        task.terrain, num_rows=2, num_cols=2, border_size=4.0))
    real = train_script.get_cfgs
    train_script.get_cfgs = lambda name: (task, train)
    try:
        train_script.main(["--task", "lite3_dtc", "--device", "cpu",
                           "--max_iterations", "1", "--log_root", str(root)])
    finally:
        train_script.get_cfgs = real
    return str(root)


def _args(log_root, *extra, parse=common.parse_args):
    return parse(["--device", "cpu", "--log_root", log_root, *extra])


def test_play_script_renders(log_root, tmp_path, capsys):
    gif = str(tmp_path / "gait.gif")
    frames = play.play(_args(log_root, "--render", "--render_steps", "4",
                             "--render_path", gif),
                       steps=11, transform=tiny,
                       png_dir=str(tmp_path))
    assert len(frames) == 4
    from PIL import Image
    im = Image.open(gif)
    assert im.format == "GIF"
    im.seek(1)                       # stride 2: frames 0 and 2
    assert os.path.exists(tmp_path / "dtc_debug_00000.png")
    out = capsys.readouterr().out
    assert "Loading policy from" in out and "step    10" in out
    assert "env-steps/s" in out


def test_play_single_and_plane_scripts(log_root, capsys):
    for fn in (play_single.play_single, play_plane.play_plane):
        logger = fn(_args(log_root), steps=3, transform=tiny)
        assert len(logger.state_log["base_z"]) == 3
        assert all(np.isfinite(logger.state_log["vel_x"]))
    assert capsys.readouterr().out.count("step     2 cmd_x=") == 2
    env, _, _ = play_plane.setup(_args(log_root), transform=tiny)
    assert env.terrain is None and env.num_envs == 1


def test_eval_stones_script(log_root):
    rep = eval_stones.evaluate(_args(log_root), num_envs=N, steps=4,
                               difficulty=0.3, transform=tiny)
    assert rep["envs"] == N and rep["steps"] == 4
    assert rep["terrain"] == "stepping_stones(difficulty=0.3, stone=0.75m)"
    assert np.isfinite(rep["tracking_err_xy_mean_mps"])


@pytest.mark.parametrize("level", [-1, 1])
def test_analyze_terminations_script(log_root, capsys, level):
    args = _args(log_root, "--num_envs", str(N), "--steps", "4", "--level",
                 str(level), parse=analyze_terminations.parse_args)
    env, runner, _ = analyze_terminations.setup(args,
                                                transform=tiny)
    if level >= 0:
        assert (runner.env_state["terrain_levels"] == level).all()
    stats = analyze_terminations.analyze(args, transform=tiny)
    assert stats["ep_len_sum"] + stats["n_done"] >= 0
    assert len(stats["done_by_type"]) == env.cfg.terrain.num_cols
    out = capsys.readouterr().out
    assert f"over {N} envs x 4 steps" in out and "term_timeout" in out


@pytest.mark.parametrize("zero", [False, True])
def test_teleop_builds_from_checkpoint(log_root, zero):
    args = _args(log_root, *(["--zero_policy"] if zero else []),
                 parse=teleop.parse_args)
    sess = teleop.build(args, transform=tiny)
    assert sess.env.num_envs == N and sess.env.cfg.env.debug_viz
    for k in "wwa":
        assert sess.handle_key(ord(k))
    tel = sess.step()
    assert np.isfinite(tel["vel"]).all()
    assert len(sess.ascii_map(9, 15)) == 9


def test_scripts_refuse_a_missing_card(log_root, monkeypatch):
    """No script carries on on the CPU when asked for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        play_single.setup(common.parse_args(["--log_root", log_root]),
                          transform=tiny)
