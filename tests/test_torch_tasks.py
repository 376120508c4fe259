"""The port's other heightfield tasks against the JAX package: x30_dtc,
x30_rough and lite3_rough, and the staged X30 protocol's checkpoint hand-off.

Two policy steps of each task at the recipe of tests/test_torch_env.py
(4 envs, decimation 2, 2x2 terrain tiles; obs noise and pushes off, no env
resets): the JAX env on its kernel path (Pallas kernels in interpret
mode) and the port's env (the kernels' plain versions on the CPU) from
one state, converted with env_from_jax, the JAX step's draws fed to the
port.  x30_dtc is the X30 robot (other links, masses and gains) at
horizontal scale 0.1 with the planner; x30_rough (53-dim obs, foothold
block zero) and lite3_rough (45-dim obs) run without the planner, so
they take the non-DTC termination (13-row height band, 0.1 m, and the
base below its feet) and no planner kernel.  Budget: the JAX package's
single-step physics tolerance (atol 2e-5, rtol 1e-5) on the physics
state of both steps, 1e-4 on the torques, observations and rewards,
which carry it through scaled sums; done flags equal.  One JAX run per
task, shared by the module.

The init and a masked reset of x30_rough and lite3_rough (origins,
levels, types and the physics state) equal the JAX env's, the port fed
the JAX draws.  x30_dtc_descent's command clamp is held to the JAX env's
`_clamp_descent_commands` on fixed commands, types and levels; an
x30_rough checkpoint loaded into an x30_dtc runner carries the params,
both optimizers, the learning rate and the iteration and keeps a fresh
env state, as the JAX runner's `load` decides; and the train script runs
the protocol's two stages with --resume --load_run.
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env.legged_env import LeggedEnv as JEnv
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu_torch.convert import env_from_jax
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv as TEnv
from deep_tracking_control_tpu_torch.runner.train import (OnPolicyRunner,
                                                          _same_layout)
from deep_tracking_control_tpu_torch.scripts import train as train_script
from deep_tracking_control_tpu_torch.tasks import registry as treg
from tests.test_torch_env import OBS, PHYS, N, _clone, _jax_draws, _np

TASKS = ("x30_dtc", "x30_rough", "lite3_rough")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(reg, name, num_envs=N, quiet=True):
    """`name` at the small recipe: decimation 2, 2x2 tiles of 4 m border."""
    task, train = reg.get_cfgs(name)
    task = dataclasses.replace(
        task,
        env=dataclasses.replace(task.env, num_envs=num_envs),
        control=dataclasses.replace(task.control, decimation=2),
        terrain=dataclasses.replace(task.terrain, num_rows=2, num_cols=2,
                                    border_size=4.0, max_init_terrain_level=1))
    if quiet:
        task = dataclasses.replace(
            task, noise=dataclasses.replace(task.noise, add_noise=False),
            domain_rand=dataclasses.replace(task.domain_rand,
                                            push_robots=False))
    return task, train


def two_steps(name):
    """Two steps of `name` in both packages from one state: the JAX env on
    its kernel path where it has one (interpret mode), else its XLA path."""
    jenv = JEnv(tiny(jreg, name)[0])
    params, state0 = jenv.init(jax.random.PRNGKey(0))
    jenv._pallas_interpret = True
    jenv._pallas_physics = jenv.patch_src is not None
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    actions = (0.3 * rng.normal(size=(2, N, 12))).astype(np.float32)
    keys = [jax.random.PRNGKey(100), jax.random.PRNGKey(101)]

    tenv = TEnv(tiny(treg, name)[0], device="cpu")
    plane = jenv.patch_src is None
    tparams, tstate = env_from_jax(
        _np(params), _np(state0),
        None if plane else np.asarray(jenv.grid.height), tenv,
        None if plane else np.asarray(jenv.terrain_origins))
    jstate, jouts, touts, tstates, jstates = state0, [], [], [], []
    for t in range(2):
        jstate, jout = jstep(params, jstate, jnp.asarray(actions[t]), keys[t])
        tstate, tout = tenv.step(tparams, tstate, torch.from_numpy(actions[t]),
                                 torch.Generator().manual_seed(t),
                                 draws=_jax_draws(jenv, keys[t]))
        jouts.append(_np(jout))
        jstates.append(_np(jstate))
        # snapshots: the port's step updates the episode sums in place
        touts.append(_clone(tout))
        tstates.append(_clone(tstate))
    return dict(jenv=jenv, tenv=tenv, jouts=jouts, touts=touts,
                jstates=jstates, tstates=tstates)


# the checks of a two-step run, shared with tests/test_torch_plane.py

def check_physics(run, t):
    js, ts = run["jstates"][t], run["tstates"][t]
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(ts["phys"][k].numpy(), js["phys"][k],
                                   **PHYS, err_msg=k)
    np.testing.assert_allclose(ts["anchors"].numpy(), js["anchors"], **PHYS)
    np.testing.assert_allclose(ts["torques"].numpy(), js["torques"],
                               **OBS)


def check_terrain_and_plan(run, t):
    js, ts = run["jstates"][t], run["tstates"][t]
    np.testing.assert_allclose(ts["measured_heights"].numpy(),
                               js["measured_heights"], atol=1e-5)
    np.testing.assert_allclose(ts["measured_foot_clearance"].numpy(),
                               js["measured_foot_clearance"], **OBS)
    np.testing.assert_allclose(ts["planes"].numpy(), js["planes"], **OBS)
    np.testing.assert_allclose(ts["foothold_obs"].numpy(), js["foothold_obs"],
                               atol=1e-6)
    np.testing.assert_allclose(ts["optimal_footholds_world"].numpy(),
                               js["optimal_footholds_world"], **OBS)
    np.testing.assert_array_equal(ts["env_origins"].numpy(),
                                  js["env_origins"])


def check_output(run, t, field):
    jo, to = run["jouts"][t], run["touts"][t]
    np.testing.assert_allclose(to[field].numpy(), jo[field], **OBS,
                               err_msg=field)


def check_done_and_metrics(run, t):
    jo, to = run["jouts"][t], run["touts"][t]
    np.testing.assert_array_equal(to["done"].numpy(), jo["done"])
    assert not jo["done"].any(), "the compared steps must not reset"
    np.testing.assert_array_equal(to["time_out"].numpy(), jo["time_out"])
    assert set(to["metrics"]) == set(jo["metrics"])
    for k, v in jo["metrics"].items():
        np.testing.assert_allclose(float(to["metrics"][k]), float(v),
                                   **OBS, err_msg=k)
    js, ts = run["jstates"][t], run["tstates"][t]
    np.testing.assert_allclose(ts["episode_sums"].numpy(), js["episode_sums"],
                               **OBS)


def jax_reset_draws(jenv, key):
    """The port's reset draws from the JAX `_apply_reset`'s key
    (legged_env.py:974, 1004-1024): the curriculum's random levels, and
    the joint scale, xy offset and root velocity as uniforms in [-1, 1)
    (exact: the ranges' scales are powers of two)."""
    cfg, n, nq = jenv.cfg, jenv.num_envs, jenv.model.nq
    keys = jax.random.split(key, 10)
    lo, hi = cfg.domain_rand.init_joint_range
    xy_off = 0.5 if cfg.use_dtc_planner else 1.0
    scale = np.asarray(jax.random.uniform(keys[1], (n, nq), minval=lo,
                                          maxval=hi))
    xy = np.asarray(jax.random.uniform(keys[2], (n, 2), minval=-xy_off,
                                       maxval=xy_off))
    vel = np.asarray(jax.random.uniform(keys[3], (n, 6), minval=-0.5,
                                        maxval=0.5))
    u = np.concatenate([(scale - np.float32(lo)) / np.float32(0.5 * (hi - lo))
                        - np.float32(1.0), xy / np.float32(xy_off),
                        vel / np.float32(0.5)], axis=1)
    levels = jax.random.randint(keys[0], (n,), 0, cfg.terrain.num_rows)
    return dict(reset_uniforms=torch.from_numpy(u.astype(np.float32)),
                reset_levels=torch.from_numpy(
                    np.asarray(levels).astype(np.int32)))


def init_and_reset(name, num_envs=7):
    """JAX's `init` and a masked `_apply_reset` beside the port's, the port
    fed the JAX draws (its init's levels from the same key split,
    legged_env.py:242, 272).  The reset starts from the JAX init's state
    with envs 0 and 2 reset: env 0 at level 1 on its origin (its level
    moves down where a curriculum runs), env 2 at level 0, 6 m off it
    (moves up).  Returns the
    two packages' init states and reset states (numpy and torch)."""
    jenv = JEnv(tiny(jreg, name, num_envs=num_envs)[0])
    tenv = TEnv(tiny(treg, name, num_envs=num_envs)[0], device="cpu")
    key = jax.random.PRNGKey(3)
    jparams, jstate = jenv.init(key)
    *_, klev, _, krst = jax.random.split(key, 8)
    draws = jax_reset_draws(jenv, krst)
    if jenv.custom_origins:
        np.testing.assert_array_equal(tenv.terrain_origins.numpy(),
                                      np.asarray(jenv.terrain_origins))
        tc = jenv.cfg.terrain
        top = tc.max_init_terrain_level if tc.curriculum else tc.num_rows - 1
        draws["init_levels"] = torch.from_numpy(np.array(
            jax.random.randint(klev, (num_envs,), 0, top + 1)))
    _, tinit = tenv.init(torch.Generator().manual_seed(0), draws=draws)

    js = dict(_np(jstate))
    if jenv.custom_origins:
        levels = np.array(js["terrain_levels"])
        levels[[0, 2]] = [1, 0]
        js["terrain_levels"] = levels
        js["env_origins"] = np.asarray(jenv.terrain_origins)[
            levels, js["terrain_types"]].astype(np.float32)
    pos = np.array(js["phys"]["pos"])
    pos[:2, 0] = js["env_origins"][0, :2]
    pos[:2, 2] = js["env_origins"][2, :2] + 6.0
    js["phys"] = {**js["phys"], "pos": pos}
    js["commands"] = np.tile(np.float32([0.5, 0.0, 0.0, 0.0]), (num_envs, 1))
    done = np.zeros(num_envs, bool)
    done[[0, 2]] = True
    key = jax.random.PRNGKey(7)
    jreset = _np(jenv._apply_reset(jax.tree.map(jnp.asarray, js),
                                   jnp.asarray(done), key))
    plane = not jenv.custom_origins
    tparams, tstate = env_from_jax(
        _np(jparams), js, None if plane else np.asarray(jenv.grid.height),
        tenv, None if plane else np.asarray(jenv.terrain_origins))
    treset = tenv._apply_reset(tparams, tstate, torch.from_numpy(done),
                               torch.Generator().manual_seed(1),
                               draws=jax_reset_draws(jenv, key))
    return dict(jenv=jenv, tenv=tenv, jinit=_np(jstate), tinit=tinit,
                jreset=jreset, treset=treset, done=done)


def check_init_and_reset(r):
    """Origins, levels, types and the whole physics state equal after the
    init and after the masked reset."""
    for stage in ("init", "reset"):
        want, got = r["j" + stage], r["t" + stage]
        for k in ("env_origins", "terrain_levels", "terrain_types"):
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{stage} {k}")
        for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
            np.testing.assert_array_equal(got["phys"][k].numpy(),
                                          want["phys"][k],
                                          err_msg=f"{stage} {k}")


FIELDS = ["obs", "privileged_obs", "obs_history", "base_vel", "rew"]


@pytest.fixture(scope="module", params=TASKS)
def run(request):
    return two_steps(request.param)


@pytest.mark.parametrize("t", [0, 1])
def test_task_physics_state(run, t):
    check_physics(run, t)


@pytest.mark.parametrize("t", [0, 1])
def test_task_terrain_queries_and_plan(run, t):
    check_terrain_and_plan(run, t)
    ts = run["tstates"][t]
    if not run["tenv"].cfg.use_dtc_planner:
        assert not ts["foothold_obs"].any()


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("field", FIELDS)
def test_task_outputs(run, t, field):
    check_output(run, t, field)


@pytest.mark.parametrize("t", [0, 1])
def test_task_done_and_metrics(run, t):
    check_done_and_metrics(run, t)


def test_task_layouts(run):
    """The obs width of each task (53 with the foothold block, zero without
    the planner; 45 without it) and the episode-sum rows in the JAX
    package's order."""
    tenv, jenv = run["tenv"], run["jenv"]
    assert tenv.num_obs == jenv.num_obs
    assert tenv._obs_has_foothold == jenv._obs_has_foothold
    assert tenv.episode_sum_names == jenv.episode_sum_names
    assert run["touts"][0]["obs"].shape == (N, jenv.num_obs)
    if not tenv.cfg.use_dtc_planner and tenv._obs_has_foothold:
        assert not run["touts"][1]["obs"][:, -8:].any()


@pytest.mark.parametrize("name", ["lite3_rough", "x30_rough"])
def test_init_and_reset_match_jax(name):
    """Without the planner: origins on the tiles, levels from the
    curriculum (env 0 down a level, env 2 up), the xy offset U(-1, 1)."""
    r = init_and_reset(name)
    check_init_and_reset(r)
    want = r["jreset"]
    np.testing.assert_array_equal(want["terrain_levels"][[0, 2]], [0, 1])
    off = (want["phys"]["pos"][:2].T - want["env_origins"][:, :2])
    assert np.abs(off).max() <= 1.0 and np.abs(off).max() > 0.5


def test_descent_clamp_matches_jax():
    """x30_dtc_descent: planar commands capped at 0.5 m/s on the descent
    columns at level >= 6, direction kept, yaw untouched; elsewhere the
    commands pass as they are (the JAX env's `_clamp_descent_commands` on
    the same fixed inputs).  The full 10 columns of the curriculum."""
    def env(reg, cls, **kw):
        task, _ = reg.get_cfgs("x30_dtc_descent")
        task = dataclasses.replace(
            task, env=dataclasses.replace(task.env, num_envs=N),
            terrain=dataclasses.replace(task.terrain, num_rows=2,
                                        border_size=4.0))
        return cls(task, **kw)
    jenv, tenv = env(jreg, JEnv), env(treg, TEnv, device="cpu")
    cols = np.asarray(jenv._descent_cols)
    np.testing.assert_array_equal(tenv._descent_cols.numpy(), cols)
    assert cols.any() and not cols.all()
    rng = np.random.default_rng(4)
    M = 64
    commands = rng.uniform(-1.5, 1.5, (M, 4)).astype(np.float32)
    commands[:4, :2] = [[0.3, 0.2], [0.0, 0.0], [1.0, 0.0], [-0.4, 0.35]]
    types = rng.integers(0, 10, M).astype(np.int32)
    levels = rng.integers(0, 10, M).astype(np.int32)
    types[:4] = np.flatnonzero(cols)[0]
    levels[:4] = 6
    want = np.asarray(jenv._clamp_descent_commands(
        jnp.asarray(commands), jnp.asarray(types), jnp.asarray(levels)))
    got = tenv._clamp_descent_commands(
        torch.from_numpy(commands), torch.from_numpy(types),
        torch.from_numpy(levels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    speed = np.linalg.norm(got[:, :2], axis=1)
    on = cols[types] & (levels >= 6)
    assert np.all(speed[on] <= 0.5 + 1e-6)
    np.testing.assert_array_equal(got[~on], commands[~on])
    np.testing.assert_array_equal(got[:, 2:], commands[:, 2:])
    assert (np.linalg.norm(commands[on, :2], axis=1) > 0.5).any()


def _staged_cfgs(name):
    task, train = tiny(treg, name, num_envs=16, quiet=False)
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(train.policy, terrain_latent=32,
                                   actor_hidden_dims=(32,),
                                   critic_hidden_dims=(32,)),
        runner=dataclasses.replace(train.runner, num_steps_per_env=8,
                                   save_interval=1))
    return task, train


def _runner(name):
    task, train = _staged_cfgs(name)
    return OnPolicyRunner(TEnv(task, device="cpu"), train)


def test_rough_checkpoint_into_dtc_runner(tmp_path):
    """An x30_rough checkpoint (one learn iteration, full save) loaded into
    an x30_dtc runner: params, both optimizers, the learning rate and the
    iteration transfer; the env state stays the fresh one, because the
    episode-sum rows differ (17 against 18 terms).  The JAX runner's
    `load` decides the same on the JAX envs' states: it adopts a stored
    env state only when every leaf's shape and dtype match."""
    path = str(tmp_path / "model_1.pt")
    a = _runner("x30_rough")
    a.learn(1)
    a.save(path)
    b = _runner("x30_dtc")
    fresh = b.env_state
    fresh_copy = _clone(fresh)
    assert not _same_layout(a.env_state, b.env_state)
    b.load(path)
    assert b.env_state is fresh
    for k, v in fresh_copy.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b.env_state[k]), k
    assert b.current_learning_iteration == 1
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert torch.equal(a.ppo.learning_rate, b.ppo.learning_rate)
    for oa, ob in ((a.ppo.optimizer, b.ppo.optimizer),
                   (a.ppo.vae_optimizer, b.ppo.vae_optimizer)):
        assert torch.equal(oa.mu, ob.mu) and torch.equal(oa.nu, ob.nu)
        assert int(oa.count) == int(ob.count)
    rows = b.learn(1)
    assert np.isfinite(rows[0]["value_loss"])

    # the JAX runner's rule (runner/train.py load: same tree structure and
    # every leaf's shape and dtype) on the JAX envs' initial states
    states = {name: JEnv(tiny(jreg, name, num_envs=16)[0]).init(
        jax.random.PRNGKey(0))[1] for name in ("x30_rough", "x30_dtc")}
    sj, dj = states["x30_rough"], states["x30_dtc"]
    jax_adopts = (jax.tree.structure(sj) == jax.tree.structure(dj) and all(
        a.shape == b.shape and a.dtype == b.dtype
        for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(dj))))
    assert not jax_adopts
    assert (sj["episode_sums"].shape[0], dj["episode_sums"].shape[0]) == (
        a.env_state["episode_sums"].shape[0],
        b.env_state["episode_sums"].shape[0]) == (17, 18)


def test_staged_protocol_through_the_train_script(tmp_path, monkeypatch):
    """The two stages of train_x30_staged.sh through the entry point on
    the CPU: x30_rough for one iteration, then x30_dtc --resume --load_run
    of that run (linked under x30_dtc/, as the script does), which starts
    from the rough run's iteration."""
    cfgs = {n: _staged_cfgs(n) for n in ("x30_rough", "x30_dtc")}
    monkeypatch.setattr(train_script, "get_cfgs", lambda name: cfgs[name])
    root = str(tmp_path)
    rough = train_script.main(["--task", "x30_rough", "--device", "cpu",
                               "--max_iterations", "1", "--log_root", root])
    assert rough.current_learning_iteration == 1
    (run,) = os.listdir(tmp_path / "rough_X30")
    os.makedirs(tmp_path / "x30_dtc")
    os.symlink(tmp_path / "rough_X30" / run, tmp_path / "x30_dtc" / run)
    dtc = train_script.main(["--task", "x30_dtc", "--device", "cpu",
                             "--max_iterations", "1", "--log_root", root,
                             "--resume", "--load_run", run])
    assert dtc.current_learning_iteration == 2
    assert dtc.env.num_obs == rough.env.num_obs == 53
