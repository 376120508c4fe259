"""The rollout slice of the torch port as a whole against the JAX package.

Two policy steps of lite3_dtc (4 envs, decimation 2, 2x2 terrain, the
recipe of tests/test_pallas_substep.py:22-34) from one state: the JAX env
on its kernel path (Pallas kernels in interpret mode) and the port's env
(the kernels' plain versions on the CPU), the port's state and world
converted with env_from_jax.  Obs noise and pushes are off and no env
resets in these steps, so the step's random draws are the action-lag
indices and the privileged height-scan noise; the test makes both from
the JAX key exactly as legged_env.step does (legged_env.py:388, 444, 537,
1172, 1180) and hands them to the port.  Budget: the JAX package's
single-step physics tolerance (atol 2e-5, rtol 1e-5) on the physics
state, 1e-4 on observations and rewards, which carry it through scaled
sums; done flags equal.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env.legged_env import LeggedEnv as JEnv
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu_torch.convert import env_from_jax
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv as TEnv
from deep_tracking_control_tpu_torch.env.vec_env import VecEnv
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.tasks import registry as treg
from tests.xdist_once import once

N = 4
PHYS = dict(atol=2e-5, rtol=1e-5)
OBS = dict(atol=1e-4, rtol=1e-4)


def _tiny(reg, **extra):
    task, train = reg.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task,
        env=dataclasses.replace(task.env, num_envs=N),
        control=dataclasses.replace(task.control, decimation=2),
        terrain=dataclasses.replace(task.terrain, num_rows=2, num_cols=2,
                                    border_size=4.0, max_init_terrain_level=1),
        **extra)
    return task, train


def _quiet(reg):
    task, _ = _tiny(reg)
    return _tiny(reg, noise=dataclasses.replace(task.noise, add_noise=False),
                 domain_rand=dataclasses.replace(task.domain_rand,
                                                 push_robots=False))[0]


def _jax_draws(env, key):
    """The two draws of JAX's step on this path, from its key chain."""
    k_lag, k_post = jax.random.split(key)
    lag = jax.random.randint(k_lag, (env.cfg.control.decimation,), 1, 5)
    k_obs = jax.random.split(k_post, 8)[4]
    k_h = jax.random.split(k_obs)[0]
    noise = jax.random.uniform(k_h, (N, env.num_height_points),
                               minval=-1.0, maxval=1.0)
    return dict(lag=torch.from_numpy(np.asarray(lag).astype(np.int64)),
                height_noise=torch.from_numpy(np.array(noise)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _kernel_path(jenv):
    """The JAX env on its kernel path, kernels in interpret mode."""
    jenv._pallas_interpret = True
    jenv._pallas_physics = True
    return jenv


def _jax_slice():
    """The JAX env's init and two steps, with the draws it made, as numpy
    (the draws as the port takes them)."""
    jenv = JEnv(_quiet(jreg))
    params, state0 = jenv.init(jax.random.PRNGKey(0))
    _kernel_path(jenv)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    actions = (0.3 * rng.normal(size=(2, N, 12))).astype(np.float32)
    keys = [jax.random.PRNGKey(100), jax.random.PRNGKey(101)]
    jstate, jouts, jstates, draws = state0, [], [], []
    for t in range(2):
        jstate, jout = jstep(params, jstate, jnp.asarray(actions[t]), keys[t])
        draws.append(_jax_draws(jenv, keys[t]))
        jouts.append(_np(jout))
        jstates.append(_np(jstate))
    return dict(actions=actions, params=_np(params), state0=_np(state0),
                height=np.asarray(jenv.grid.height),
                origins=np.asarray(jenv.terrain_origins), draws=draws,
                jouts=jouts, jstates=jstates)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """The JAX slice (once a test session: tests/xdist_once.py; the
    outputs are checked in tests/test_torch_env_outputs.py) and the
    port's two steps from its state with its draws."""
    run = once(tmp_path_factory, "torch_env_slice", _jax_slice)
    tenv = TEnv(_quiet(treg), device="cpu")
    tparams, tstate = env_from_jax(run["params"], run["state0"],
                                   run["height"], tenv, run["origins"])
    touts, tstates = [], []
    for t in range(2):
        tstate, tout = tenv.step(tparams, tstate,
                                 torch.from_numpy(run["actions"][t]),
                                 torch.Generator().manual_seed(t),
                                 draws=run["draws"][t])
        # snapshots: the port's step updates the episode sums in place
        touts.append(_clone(tout))
        tstates.append(_clone(tstate))
    return dict(run, tenv=tenv, tparams=tparams, touts=touts,
                tstates=tstates)


@pytest.mark.parametrize("t", [0, 1])
def test_slice_physics_state(slice_run, t):
    js, ts = slice_run["jstates"][t], slice_run["tstates"][t]
    tol = PHYS if t == 0 else dict(atol=1e-4, rtol=1e-4)
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(ts["phys"][k].numpy(), js["phys"][k],
                                   **tol, err_msg=k)
    np.testing.assert_allclose(ts["anchors"].numpy(), js["anchors"], **tol)


@pytest.mark.parametrize("t", [0, 1])
def test_slice_terrain_queries_and_plan(slice_run, t):
    js, ts = slice_run["jstates"][t], slice_run["tstates"][t]
    np.testing.assert_allclose(ts["measured_heights"].numpy(),
                               js["measured_heights"], atol=1e-5)
    np.testing.assert_allclose(ts["measured_foot_clearance"].numpy(),
                               js["measured_foot_clearance"], **OBS)
    np.testing.assert_allclose(ts["planes"].numpy(), js["planes"], **OBS)
    np.testing.assert_allclose(ts["foothold_obs"].numpy(), js["foothold_obs"],
                               atol=1e-6)
    np.testing.assert_allclose(ts["optimal_footholds_world"].numpy(),
                               js["optimal_footholds_world"], **OBS)


@pytest.mark.parametrize("t", [0, 1])
def test_slice_done_and_metrics(slice_run, t):
    jo, to = slice_run["jouts"][t], slice_run["touts"][t]
    np.testing.assert_array_equal(to["done"].numpy(), jo["done"])
    assert not jo["done"].any(), "the compared steps must not reset"
    np.testing.assert_array_equal(to["time_out"].numpy(), jo["time_out"])
    for k, v in jo["metrics"].items():
        np.testing.assert_allclose(float(to["metrics"][k]), float(v),
                                   **OBS, err_msg=k)
    js, ts = slice_run["jstates"][t], slice_run["tstates"][t]
    np.testing.assert_allclose(ts["episode_sums"].numpy(), js["episode_sums"],
                               **OBS)


def test_reset_writes_deterministic_fields(slice_run):
    """Masked reset of envs 0 and 2 after the two steps: episode length and
    sums flushed, curriculum levels moved, everything of envs 1 and 3
    kept.  Env 0 sits on its origin (moves down a level), env 2 far off it
    (moves up), so no level leaves [0, num_rows) and no draw decides one."""
    jenv, tenv = _kernel_path(JEnv(_quiet(jreg))), slice_run["tenv"]
    js = slice_run["jstates"][1]
    tparams = slice_run["tparams"]
    js = dict(js)
    levels = np.array([1, 1, 0, 0], np.int32)
    origins = slice_run["origins"][levels, js["terrain_types"]]
    pos = np.array(js["phys"]["pos"])
    pos[:2, 0] = origins[0, :2]
    pos[:2, 2] = origins[2, :2] + 6.0
    js["phys"] = {**js["phys"], "pos": pos}
    js["terrain_levels"] = levels
    js["env_origins"] = origins.astype(np.float32)
    js["commands"] = np.tile(np.float32([0.5, 0.0, 0.0, 0.0]), (N, 1))
    done = np.array([True, False, True, False])
    want = _np(jenv._apply_reset(jax.tree.map(jnp.asarray, js),
                                 jnp.asarray(done), jax.random.PRNGKey(7)))
    _, tstate = env_from_jax(slice_run["params"], js, slice_run["height"],
                             tenv, slice_run["origins"])
    got = tenv._apply_reset(tparams, tstate, torch.from_numpy(done),
                            torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got["terrain_levels"].numpy(), [0, 1, 1, 0])
    np.testing.assert_array_equal(got["terrain_levels"].numpy(),
                                  want["terrain_levels"])
    np.testing.assert_array_equal(got["env_origins"].numpy(),
                                  want["env_origins"])
    for k in ("episode_length", "episode_sums", "last_actions",
              "feet_air_time", "lag_buffer", "cmd_buffer", "pitch_est",
              "command_lin_vel_x"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    keep = ~done
    for k in ("q", "qd", "pos", "quat"):
        np.testing.assert_array_equal(got["phys"][k].numpy()[:, keep],
                                      want["phys"][k][:, keep], err_msg=k)
    np.testing.assert_array_equal(got["planes"].numpy()[:, 0][:, done], -1e4)
    p = got["phys"]["pos"].numpy()
    np.testing.assert_array_equal(got["anchors"].numpy()[:, :, done],
                                  np.broadcast_to(p[:2, done], (20, 2, 2)))
    # reset bases respawn within 0.5 m of their new origin, 0.4 m above it
    d = p[:, done].T - got["env_origins"].numpy()[done]
    assert np.all(np.abs(d[:, :2]) <= 0.5) and np.allclose(d[:, 2], 0.4)


def test_runner_collects_a_rollout():
    task, train = _tiny(treg)
    env = TEnv(task, device="cpu")
    runner = OnPolicyRunner(env, train)
    T = train.runner.num_steps_per_env
    for _ in range(2):
        batch, aux = runner.collect()
        assert batch["obs"].shape == (T, N, env.num_obs)
        assert batch["privileged_obs"].dtype == torch.bfloat16
        assert batch["obs_history"].shape == (T, N, env.num_obs_history)
        for k, v in batch.items():
            assert torch.isfinite(v.float()).all(), k
        assert torch.isfinite(torch.stack([torch.as_tensor(v) for v in
                                           aux.values()])).all()
    vec = VecEnv(env, seed=1)
    obs, rew, done, extras = vec.step(torch.zeros(N, env.num_actions))
    assert obs["obs"].shape == (N, env.num_obs) and rew.shape == (N,)
    assert vec.reset()["obs_history"].shape == (N, env.num_obs_history)
