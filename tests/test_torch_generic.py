"""The port's generic articulated-body engine, more than one physics
substep, and a robot that is not a 4x3 quadruped, against the JAX package.

* `engine.fk` and `engine.aba` (body by body over any revolute tree) on
  Lite3, X30 and a three-legged robot (Lite3's URDF with its HR_ leg
  removed: 10 dynamic bodies, 9 joints, 3 feet; chip_smoke.three_leg_urdf)
  against the JAX engine's, from random states and forces as in
  tests/test_quadruped_path.py, at 3 envs.  Budget: R and x 1e-5, v 1e-4
  (the JAX test's); qdd and a0 1e-4 + 1e-5 rel: float32 rounding through
  the recursions at accelerations of a few hundred, far inside the JAX
  test's 2e-2 + 2e-3 rel between its two engines.
* The port's generic path against its own leg-batched one on Lite3 and
  X30 (the two cases of tests/test_quadruped_path.py, at its budgets), and
  one `sim_step` of each from the same state (chip_smoke.check_engines,
  which chip_smoke.py phase 12 applies on the card: 1e-4 + 1e-4 rel;
  contact forces 1e-2 N, the decimation step's budget).
* `sim_step` of the three-legged robot, 3 calls at `substeps=2` on a
  small bumpy heightfield, against the JAX `sim_step` (the JAX package's
  single-step budget, atol 2e-5 / rtol 1e-5; contact forces 1e-3 N).
* Two env steps against the JAX env's same route, its draws injected
  (tests/test_torch_tasks.py's recipe and checks: 4 envs, decimation 2,
  2x2 tiles, border 4 m): (a) the three-legged robot on lite3_rough with 9
  actions and 36-dim obs, (b) lite3_dtc at `substeps=2`.  Neither is the
  decimation kernel's case, so both packages run the patch copy and the
  plain decimation loop over `sim_step` (the generic engine for (a)).
* Both packages refuse the three-legged robot on lite3_dtc (its 53-dim
  obs layout assumes 12 joints and 4 feet).
* A learn(1), save and load of an 8-env runner with the three-legged
  robot, its task registered with the port's `registry.register`.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import check_engines, three_leg_task, three_leg_urdf
from deep_tracking_control_tpu.env.legged_env import LeggedEnv as JEnv
from deep_tracking_control_tpu.physics import engine as jeng
from deep_tracking_control_tpu.physics import sim as jsim
from deep_tracking_control_tpu.robot import quadrupeds as jrobots
from deep_tracking_control_tpu.robot.model import load_urdf as jload
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu.terrain import grid as jgrid
from deep_tracking_control_tpu_torch.convert import env_from_jax
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv as TEnv
from deep_tracking_control_tpu_torch.physics import engine as teng
from deep_tracking_control_tpu_torch.physics import quadruped as tquad
from deep_tracking_control_tpu_torch.physics import sim as tsim
from deep_tracking_control_tpu_torch.robot import quadrupeds as trobots
from deep_tracking_control_tpu_torch.robot.model import load_urdf as tload
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.tasks import registry as treg
from deep_tracking_control_tpu_torch.terrain import grid as tgrid
from tests.test_torch_env import N, OBS, PHYS, _clone, _jax_draws, _np
from tests.test_torch_physics_gates import use_engine
from tests.test_torch_tasks import (check_done_and_metrics, check_output,
                                    check_physics, check_terrain_and_plan,
                                    tiny)

ROBOTS = ("lite3", "x30", "three_leg")
ACCEL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return three_leg_urdf(str(tmp_path_factory.mktemp("robot")
                              / "three_leg.urdf"))


def _models(name, urdf):
    """(JAX model, port model) of `name`."""
    if name == "three_leg":
        return jload(urdf), tload(urdf)
    return jrobots.get_robot(name), trobots.get_robot(name)


def _rand_state(nq, n=3, seed=0):
    """test_quadruped_path.py's random state, as numpy float32."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(4, n))
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    s = dict(pos=rng.normal(size=(3, n)), quat=quat,
             lin_vel=rng.normal(size=(3, n)), ang_vel=rng.normal(size=(3, n)),
             q=rng.uniform(-1, 1, size=(nq, n)), qd=rng.normal(size=(nq, n)))
    return {k: v.astype(np.float32) for k, v in s.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def engine_runs(urdf):
    """fk and aba of each robot in both packages, on one random state,
    torques and external forces (3 envs); the JAX engine run eagerly, as
    tests/test_quadruped_path.py runs it."""
    runs = {}
    sim = jeng.SimParams()
    for name in ROBOTS:
        jm, tm = _models(name, urdf)
        s = _rand_state(jm.nq)
        rng = np.random.default_rng(1)
        tau = rng.normal(size=(jm.nq, 3)).astype(np.float32)
        f_ext = rng.normal(size=(jm.nb, 6, 3)).astype(np.float32)
        js = {k: jnp.asarray(v) for k, v in s.items()}
        jkin = jeng.fk(jm, js)
        jin, _ = jeng.make_inertias(jm, num_envs=3)
        jqdd, ja0 = jeng.aba(jm, jin, jkin, js["qd"], jnp.asarray(tau),
                             jnp.asarray(f_ext), sim)
        ts = _torch(s)
        tkin = teng.fk(tm, ts)
        tin, _ = teng.make_inertias(tm, num_envs=3, device="cpu")
        tqdd, ta0 = teng.aba(tm, tin, tkin, ts["qd"], torch.from_numpy(tau),
                             torch.from_numpy(f_ext), teng.SimParams())
        runs[name] = dict(jkin=jkin, tkin=tkin, jqdd=jqdd, ja0=ja0,
                          tqdd=tqdd, ta0=ta0)
    return runs


@pytest.mark.parametrize("robot", ROBOTS)
def test_fk_matches_jax(engine_runs, robot):
    run = engine_runs[robot]
    jk, tk = run["jkin"], run["tkin"]
    for k, atol in (("R", 1e-5), ("x", 1e-5), ("v", 1e-4)):
        np.testing.assert_allclose(tk[k].numpy(), np.asarray(jk[k]),
                                   atol=atol, rtol=0, err_msg=k)
    # the per-joint transforms aba reads: None at the base, as in JAX
    assert tk["E"][0] is None and tk["r"][0] is None
    for i in range(1, len(jk["E"])):
        np.testing.assert_allclose(tk["E"][i].numpy(), np.asarray(jk["E"][i]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tk["r"][i].numpy(),
                                      np.asarray(jk["r"][i]))


@pytest.mark.parametrize("robot", ROBOTS)
def test_aba_matches_jax(engine_runs, robot):
    run = engine_runs[robot]
    np.testing.assert_allclose(run["tqdd"].numpy(), np.asarray(run["jqdd"]),
                               **ACCEL)
    np.testing.assert_allclose(run["ta0"].numpy(), np.asarray(run["ja0"]),
                               **ACCEL)


def _standing_state(model, n, seed, z):
    """A robot near its standing pose, z over the ground, with random
    joint offsets and velocities: contacts on every foot."""
    rng = np.random.default_rng(seed)
    quat = np.zeros((4, n))
    quat[3] = 1.0
    quat[:3] = 0.03 * rng.normal(size=(3, n))
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    q0 = np.array([0.1 if "HipX" in j else -1.0 if "HipY" in j else 1.8
                   for j in model.joint_names])
    q0 = q0 * np.where(["R_HipX" in j for j in model.joint_names], -1, 1)
    s = dict(pos=np.stack([0.1 * rng.normal(size=n), 0.1 * rng.normal(size=n),
                           np.full(n, z)]),
             quat=quat, lin_vel=0.3 * rng.normal(size=(3, n)),
             ang_vel=0.3 * rng.normal(size=(3, n)),
             q=q0[:, None] + 0.1 * rng.normal(size=(model.nq, n)),
             qd=rng.normal(size=(model.nq, n)))
    return {k: v.astype(np.float32) for k, v in s.items()}


@pytest.mark.parametrize("robot", ["lite3", "x30"])
def test_generic_matches_leg_batched(robot, monkeypatch):
    """test_quadruped_path.py's fk and aba cases on the port, and one
    sim_step of each engine from a standing state with contacts."""
    model = trobots.get_robot(robot)
    layout = tquad.quad_layout(model)
    s = _torch(_rand_state(model.nq))
    a, b = teng.fk(model, s), tquad.fk(model, layout, s)
    np.testing.assert_allclose(a["R"].numpy(), b["R"].numpy(), atol=1e-5)
    np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(), atol=1e-5)
    np.testing.assert_allclose(a["v"].numpy(), b["v"].numpy(), atol=1e-4)
    rng = np.random.default_rng(1)
    tau = torch.from_numpy(rng.normal(size=(12, 3)).astype(np.float32))
    f_ext = torch.from_numpy(rng.normal(size=(13, 6, 3)).astype(np.float32))
    sim = teng.SimParams()
    inertias, _ = teng.make_inertias(model, num_envs=3, device="cpu")
    qa, a0a = teng.aba(model, inertias, a, s["qd"], tau, f_ext, sim)
    qb, a0b = tquad.aba(model, layout, inertias, b, s["qd"], tau, f_ext, sim)
    np.testing.assert_allclose(qa.numpy(), qb.numpy(), rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(a0a.numpy(), a0b.numpy(), rtol=2e-3,
                               atol=2e-2)

    outs = [sim_step_once(model, _standing_state(model, 3, 2, 0.3))]
    use_engine("generic", monkeypatch)
    outs.append(sim_step_once(model, _standing_state(model, 3, 2, 0.3)))
    check_engines(*outs)


def sim_step_once(model, state):
    """One port sim_step on flat ground from `state` (numpy) with PD
    torques toward the state's own pose: (state, anchors, info)."""
    geom = tsim.default_contact_geometry(model)
    n = state["pos"].shape[-1]
    s = _torch(state)
    inertias, _ = teng.make_inertias(model, num_envs=n, device="cpu")
    grid = tgrid.flat_grid(16.0, 0.05, "cpu")
    tau = 20.0 * (s["q"].mean(dim=1, keepdim=True) - s["q"]) - 0.5 * s["qd"]
    anchors = tsim.init_anchors(geom, n, device="cpu")
    return tsim.sim_step(model, geom, teng.SimParams(), inertias, s, anchors,
                         tau, lambda x, y: tgrid.height_and_slope(grid, x, y),
                         torch.ones(n), torch.zeros(n))


def _bumpy_grid(make, seed=0):
    """A 6 x 6 m heightfield at 0.05 m: smooth bumps and a 5 cm step."""
    rng = np.random.default_rng(seed)
    xs = np.arange(120) * 0.05 - 3.0
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    h = (0.02 * np.sin(3.0 * X + rng.uniform(0, 6)) * np.cos(2.0 * Y)
         + 0.05 * (X > 0.2))
    return make(h.astype(np.float32))


def test_sim_step_three_leg_matches_jax(urdf):
    """Three sim_step calls at substeps=2 of the three-legged robot on a
    bumpy heightfield, the JAX engine run eagerly."""
    jm, tm = _models("three_leg", urdf)
    sim = dataclasses.replace(jeng.SimParams(), substeps=2)
    tsimp = dataclasses.replace(teng.SimParams(), substeps=2)
    n = 3
    s = _standing_state(tm, n, 4, 0.31)
    rng = np.random.default_rng(5)
    taus = (5.0 * rng.normal(size=(3, tm.nq, n))).astype(np.float32)
    fric = np.array([1.0, 0.6, 0.9], np.float32)
    rest = np.array([0.0, 0.2, 0.1], np.float32)

    jgeom = jsim.default_contact_geometry(jm)
    jg = _bumpy_grid(lambda h: jgrid.TerrainGrid(
        jnp.asarray(h), 0.05, 3.0, is_plane=False))
    jin, _ = jeng.make_inertias(jm, num_envs=n)
    js = {k: jnp.asarray(v) for k, v in s.items()}
    janch = jsim.init_anchors(jgeom, n)

    tgeom = tsim.default_contact_geometry(tm)
    tg = _bumpy_grid(lambda h: tgrid.TerrainGrid(
        height=torch.from_numpy(h), horizontal_scale=0.05, border_size=3.0))
    tin, _ = teng.make_inertias(tm, num_envs=n, device="cpu")
    ts = _torch(s)
    tanch = tsim.init_anchors(tgeom, n, device="cpu")
    for t in range(3):
        js, janch, jinfo = jsim.sim_step(
            jm, jgeom, sim, jin, js, janch, jnp.asarray(taus[t]),
            lambda x, y: jgrid.height_and_slope(jg, x, y),
            jnp.asarray(fric), jnp.asarray(rest))
        ts, tanch, tinfo = tsim.sim_step(
            tm, tgeom, tsimp, tin, ts, tanch, torch.from_numpy(taus[t]),
            lambda x, y: tgrid.height_and_slope(tg, x, y),
            torch.from_numpy(fric), torch.from_numpy(rest))
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       **PHYS, err_msg=f"call {t}: {k}")
        np.testing.assert_allclose(tanch.numpy(), np.asarray(janch), **PHYS)
        for k in ("foot_pos", "foot_vel"):
            np.testing.assert_allclose(tinfo[k].numpy(),
                                       np.asarray(jinfo[k]), **PHYS,
                                       err_msg=k)
        np.testing.assert_allclose(tinfo["contact_forces"].numpy(),
                                   np.asarray(jinfo["contact_forces"]),
                                   atol=1e-3, rtol=1e-5)
    assert tinfo["foot_pos"].shape == (3, 3, n)
    assert float(tinfo["contact_forces"][:, 2].sum()) > 1.0, "no contact"


def _configs(reg, name, urdf):
    """The task of an env-step case at tiny's recipe (quiet): the
    three-legged lite3_rough, or lite3_dtc at substeps=2."""
    if name == "three_leg":
        task = tiny(reg, "lite3_rough")[0]
        return dataclasses.replace(
            task, asset=dataclasses.replace(task.asset, robot=urdf),
            env=dataclasses.replace(task.env, num_actions=9,
                                    num_observations=36))
    task = tiny(reg, "lite3_dtc")[0]
    return dataclasses.replace(task,
                               sim=dataclasses.replace(task.sim, substeps=2))


def _two_steps(name, urdf):
    """Two steps in both packages from one state: the JAX env on its own
    route (neither case is its kernel's: the XLA loop over sim_step)."""
    jenv = JEnv(_configs(jreg, name, urdf))
    assert not jenv._pallas_physics
    params, state0 = jenv.init(jax.random.PRNGKey(0))
    jstep = jax.jit(jenv.step)
    na = jenv.num_actions
    rng = np.random.default_rng(0)
    actions = (0.3 * rng.normal(size=(2, N, na))).astype(np.float32)
    keys = [jax.random.PRNGKey(100), jax.random.PRNGKey(101)]

    tenv = TEnv(_configs(treg, name, urdf), device="cpu")
    assert not tenv._kernel_physics and tenv._consts is None
    tparams, tstate = env_from_jax(_np(params), _np(state0),
                                   np.asarray(jenv.grid.height), tenv,
                                   np.asarray(jenv.terrain_origins))
    jstate, jouts, touts, tstates, jstates = state0, [], [], [], []
    for t in range(2):
        jstate, jout = jstep(params, jstate, jnp.asarray(actions[t]), keys[t])
        tstate, tout = tenv.step(tparams, tstate, torch.from_numpy(actions[t]),
                                 torch.Generator().manual_seed(t),
                                 draws=_jax_draws(jenv, keys[t]))
        jouts.append(_np(jout))
        jstates.append(_np(jstate))
        touts.append(_clone(tout))
        tstates.append(_clone(tstate))
    return dict(jenv=jenv, tenv=tenv, jouts=jouts, touts=touts,
                jstates=jstates, tstates=tstates)


@pytest.mark.parametrize("name", ["three_leg", "lite3_dtc_substeps2"])
def test_env_steps_match_jax(name, urdf):
    """(a) the three-legged robot on lite3_rough, (b) lite3_dtc at
    substeps=2: two steps at tests/test_torch_tasks.py's budgets."""
    run = _two_steps("three_leg" if name == "three_leg" else "dtc", urdf)
    for t in range(2):
        check_physics(run, t)
        check_terrain_and_plan(run, t)
        for field in ("obs", "privileged_obs", "obs_history", "rew"):
            check_output(run, t, field)
        check_done_and_metrics(run, t)
    if name == "three_leg":
        assert run["touts"][1]["obs"].shape == (N, 36)
        assert run["tstates"][1]["phys"]["q"].shape == (9, N)


def test_three_leg_dtc_refused_by_both(urdf):
    """lite3_dtc's 53-dim obs layout (12 joints, 4 feet, the foothold
    block) does not fit the three-legged robot: both packages refuse it
    at construction, and the port's message names the robot's layout."""
    def cfg(reg):
        task = tiny(reg, "lite3_dtc")[0]
        return dataclasses.replace(
            task, asset=dataclasses.replace(task.asset, robot=urdf))
    with pytest.raises(ValueError):
        JEnv(cfg(jreg))
    with pytest.raises(ValueError, match="9 joints, 3 feet"):
        TEnv(cfg(treg), device="cpu")


@pytest.fixture
def three_leg_registered(urdf):
    """The three-legged lite3_rough registered in the port's registry (a
    tiny net, 8 envs, 4 steps an iteration), removed afterwards."""
    def cfgs():
        task, train = three_leg_task(treg, urdf, num_envs=8)
        task = dataclasses.replace(
            task, control=dataclasses.replace(task.control, decimation=2),
            terrain=dataclasses.replace(task.terrain, num_rows=2, num_cols=2,
                                        border_size=4.0))
        train = dataclasses.replace(
            train,
            policy=dataclasses.replace(train.policy, terrain_latent=16,
                                       actor_hidden_dims=(16,),
                                       critic_hidden_dims=(16,)),
            runner=dataclasses.replace(train.runner, num_steps_per_env=4))
        return task, train
    treg.register("three_leg_rough", cfgs)
    yield "three_leg_rough"
    treg._REGISTRY.pop("three_leg_rough")


def test_three_leg_learns_saves_and_loads(three_leg_registered, tmp_path):
    task, train = treg.get_cfgs(three_leg_registered)
    runner = OnPolicyRunner(TEnv(task, device="cpu"), train)
    before = {k: v.clone() for k, v in runner.net.state_dict().items()}
    rows = runner.learn(1)
    assert runner.current_learning_iteration == 1
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "trace")
    moved = [k for k, v in runner.net.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved, "the params did not move"
    path = str(tmp_path / "model_1.pt")
    runner.save(path)
    other = OnPolicyRunner(TEnv(task, device="cpu"), train)
    other.load(path)
    assert other.current_learning_iteration == 1
    for k, v in runner.net.state_dict().items():
        assert torch.equal(other.net.state_dict()[k], v), k
    assert other.env_state["phys"]["q"].shape == (9, 8)
