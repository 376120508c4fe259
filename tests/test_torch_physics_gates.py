"""The physics engine's behavioural gates on the port: free fall, energy
in free flight, a drop that settles, standing under PD and friction on a
slope (tests/test_physics.py), on both of the port's engines, and a drop
of a robot that is not a 4x3 quadruped.

Each gate keeps tests/test_physics.py's states, step counts, gains and
thresholds, at 2 envs.  The engine is the leg-batched FK/ABA
(physics/quadruped.py) or the generic one (engine.fk/aba), forced by
making the port's quadruped detection find no layout (a monkeypatch, a
test-only device; physics/sim.py takes the generic engine then, as for
any other robot).  The free fall, drop, standing and slope envs of an
engine run as one 8-env batch (2 envs a gate) for 400 sim steps, each
gate read at its own step count: every operation of sim_step is per env
column, so an env steps as it would alone; the slope envs read the 15
degree heightfield, the others the flat grid, through one terrain
function that picks per env.  The three-legged robot (Lite3's URDF with
its HR_ leg removed; chip_smoke.three_leg_urdf) runs the generic engine
because it has no 4x3 layout.  No JAX run.
"""
import numpy as np
import pytest
import torch

from chip_smoke import three_leg_urdf
from deep_tracking_control_tpu_torch.physics import engine, quadruped
from deep_tracking_control_tpu_torch.physics import sim as psim
from deep_tracking_control_tpu_torch.physics.engine import SimParams
from deep_tracking_control_tpu_torch.robot import quadrupeds
from deep_tracking_control_tpu_torch.robot.model import load_urdf
from deep_tracking_control_tpu_torch.terrain import grid as tgrid

MODEL = quadrupeds.lite3()
GEOM = psim.default_contact_geometry(MODEL)
DEFAULT_Q = np.array([0.1, -1.0, 1.8, -0.1, -1.0, 1.8,
                      0.1, -1.0, 1.8, -0.1, -1.0, 1.8])  # lite3_dtc_config.py:58-73
ENGINES = ("leg_batched", "generic")
# the batch of an engine: gate -> (env columns, start height, PD gains)
GATES = {"free_fall": ((0, 1), 10.0, 0.0, 0.0),
         "drop": ((2, 3), 0.45, 0.0, 0.0),
         "standing": ((4, 5), 0.30, 25.0, 0.5),   # lite3_dtc_config.py:104-105
         "slope": ((6, 7), 0.34, 25.0, 0.5)}
STEPS = {"free_fall": 40, "standing": 300, "slope": 300, "drop": 400}
SLOPE = 0.27                                      # tan(15 deg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def use_engine(name, monkeypatch):
    """The generic engine for a 4x3 quadruped: the port's quadruped
    detection finds no layout."""
    if name == "generic":
        monkeypatch.setattr(quadruped, "quad_layout", lambda model: None)


def make_state(n=2, pos_z=0.4, q=None, nq=12):
    q = DEFAULT_Q if q is None else q
    pos = torch.zeros((3, n))
    pos[2] = torch.as_tensor(pos_z, dtype=torch.float32)
    quat = torch.zeros((4, n))
    quat[3] = 1.0
    return engine.make_state(
        pos=pos, quat=quat, lin_vel=torch.zeros((3, n)),
        ang_vel=torch.zeros((3, n)),
        q=torch.as_tensor(q, dtype=torch.float32)[:, None].expand(nq, n)
        .contiguous(),
        qd=torch.zeros((nq, n)))


def flat_fn():
    grid = tgrid.flat_grid(16.0, 0.05, "cpu")
    return lambda x, y: tgrid.height_and_slope(grid, x, y)


def slope_fn():
    """test_friction_holds_on_slope's 15 degree heightfield."""
    size, hs = 16.0, 0.05
    cells = int(size / hs)
    xs = np.arange(cells) * hs - size / 2
    hf = np.broadcast_to((xs * SLOPE).astype(np.float32)[:, None],
                         (cells, cells))
    grid = tgrid.TerrainGrid(height=torch.from_numpy(np.ascontiguousarray(hf)),
                             horizontal_scale=hs, border_size=size / 2)
    return lambda x, y: tgrid.height_and_slope(grid, x, y)


@pytest.fixture(scope="module")
def lite3_runs():
    """Per engine: the 8-env batch of the free fall, drop, standing and
    slope gates over 400 sim steps; the state after each gate's step
    count, and the drop's last info."""
    runs = {}
    for name in ENGINES:
        with pytest.MonkeyPatch.context() as mp:
            use_engine(name, mp)
            runs[name] = _run_lite3_batch()
    return runs


def _run_lite3_batch():
    n = 8
    z = np.zeros(n, np.float32)
    kp = torch.zeros((1, n))
    kd = torch.zeros((1, n))
    for cols, z0, p, d in GATES.values():
        z[list(cols)] = z0
        kp[0, list(cols)] = p
        kd[0, list(cols)] = d
    state = make_state(n=n, pos_z=z)
    on_slope = torch.zeros(n, dtype=torch.bool)
    on_slope[list(GATES["slope"][0])] = True
    flat, slope = flat_fn(), slope_fn()

    def terrain(x, y):
        return tuple(torch.where(on_slope, s, f)
                     for s, f in zip(slope(x, y), flat(x, y)))
    inertias, _ = engine.make_inertias(MODEL, num_envs=n, device="cpu")
    q_goal = torch.as_tensor(DEFAULT_Q, dtype=torch.float32)[:, None]
    effort = torch.as_tensor(0.8 * MODEL.effort_limit,
                             dtype=torch.float32)[:, None]
    anchors = psim.init_anchors(GEOM, n, device="cpu")
    sim = SimParams()
    ones, zeros = torch.ones(n), torch.zeros(n)
    at = {}
    for step in range(1, max(STEPS.values()) + 1):
        # PD at the default pose, clipped at 0.8 x effort (24 N m, the
        # slope gate's clip); zero gains give the zero torque of the fall
        # and the drop
        tau = torch.clamp(kp * (q_goal - state["q"]) - kd * state["qd"],
                          -effort, effort)
        state, anchors, info = psim.sim_step(MODEL, GEOM, sim, inertias,
                                             state, anchors, tau, terrain,
                                             ones, zeros)
        if step in STEPS.values():
            at[step] = (state, info)
    return at


def gate(runs, engine_name, name):
    """(state, info) of `name`'s envs after its step count."""
    state, info = runs[engine_name][STEPS[name]]
    cols = list(GATES[name][0])
    return ({k: v[..., cols] for k, v in state.items()},
            {k: v[..., cols] for k, v in info.items() if k != "kin"})


@pytest.mark.parametrize("engine_name", ENGINES)
def test_free_fall(lite3_runs, engine_name):
    """No contact (high above ground): base falls at g, no spin."""
    state, _ = gate(lite3_runs, engine_name, "free_fall")
    T = 0.2
    assert STEPS["free_fall"] == int(T / SimParams().dt)
    z = state["pos"][2].numpy()
    # z = z0 - g t^2 / 2 (semi-implicit Euler adds +g*dt*t/2 correction)
    np.testing.assert_allclose(z, 10.0 - 0.5 * 9.81 * T ** 2, atol=0.03)
    np.testing.assert_allclose(state["lin_vel"][2].numpy(), -9.81 * T,
                               atol=1e-2)
    assert np.all(np.isfinite(state["q"].numpy()))


@pytest.mark.parametrize("engine_name", ENGINES)
def test_fixed_joint_gravity_consistency(engine_name, monkeypatch):
    """With zero torque, no armature, no joint friction and no contact,
    energy is conserved over 0.2 s of free flight with swinging legs (the
    energy from engine.fk, as the JAX gate takes it)."""
    use_engine(engine_name, monkeypatch)
    sim = SimParams(armature=0.0, joint_friction=0.0)
    n = 2
    state = make_state(n=n, pos_z=50.0)
    inertias, _ = engine.make_inertias(MODEL, num_envs=n, device="cpu")
    tfn = flat_fn()

    def energy(state):
        kin = engine.fk(MODEL, state)
        e = 0.0
        for i in range(MODEL.nb):
            v = kin["v"][i]
            Iv = torch.einsum("ij...,j...->i...", inertias[i], v)
            e = e + 0.5 * torch.einsum("i...,i...->...", v, Iv)
            com_w = kin["x"][i] + torch.einsum(
                "ij...,j->i...", kin["R"][i],
                torch.as_tensor(MODEL.com[i], dtype=torch.float32))
            e = e + float(MODEL.mass[i]) * 9.81 * com_w[2]
        return e.numpy()

    anchors = psim.init_anchors(GEOM, n, device="cpu")
    e0 = energy(state)
    for _ in range(40):  # 0.2 s of free flight with swinging legs
        state, anchors, _ = psim.sim_step(MODEL, GEOM, sim, inertias, state,
                                          anchors, torch.zeros((12, n)), tfn,
                                          torch.ones(n), torch.zeros(n))
    np.testing.assert_allclose(energy(state), e0, rtol=2e-3)


def check_drop(state, info, model):
    """The drop gate: the robot collapses onto its belly and rests; the
    contact force carries its weight."""
    z = state["pos"][2].numpy()
    assert np.all(z > 0.05) and np.all(z < 0.5), f"settled z={z}"
    v = state["lin_vel"].numpy()
    assert np.all(np.abs(v) < 0.2), f"residual vel {v}"
    assert np.all(info["foot_pos"][:, 2].numpy() < 0.1)
    fz = info["contact_forces"][:, 2].sum(0).numpy()
    np.testing.assert_allclose(fz, model.mass.sum() * 9.81, rtol=0.15)


@pytest.mark.parametrize("engine_name", ENGINES)
def test_drop_settles(lite3_runs, engine_name):
    """Drop with zero torque from 0.45 m: settled after 2 s."""
    check_drop(*gate(lite3_runs, engine_name, "drop"), MODEL)


@pytest.mark.parametrize("engine_name", ENGINES)
def test_standing_with_pd(lite3_runs, engine_name):
    """PD at the default pose keeps the robot upright for 1.5 s."""
    state, _ = gate(lite3_runs, engine_name, "standing")
    z = state["pos"][2].numpy()
    # gravity sag against kp=25 brings stance from 0.28 to ~0.21
    assert np.all(z > 0.15) and np.all(z < 0.4), f"standing height {z}"
    up = state["quat"][3].numpy()  # w close to 1 => roughly upright
    assert np.all(np.abs(up) > 0.99), f"tilted, quat w = {up}"
    q = state["q"].numpy()
    np.testing.assert_allclose(q, np.broadcast_to(DEFAULT_Q[:, None], q.shape),
                               atol=0.4)
    # near-static: a small stiction/PD limit cycle (~0.1 rad/s) is fine
    assert np.all(np.abs(state["qd"].numpy()) < 0.5), \
        "did not reach near-static equilibrium"


@pytest.mark.parametrize("engine_name", ENGINES)
def test_friction_holds_on_slope(lite3_runs, engine_name):
    """On a 15-degree slope with mu=1.0 the standing robot must not slide."""
    state, _ = gate(lite3_runs, engine_name, "slope")
    x = state["pos"][0].numpy()
    assert np.all(np.abs(x) < 0.25), f"slid to x={x}"
    assert np.all(state["pos"][2].numpy() > 0.1)


def test_three_leg_drop_settles(tmp_path):
    """The drop gate for the three-legged robot (the generic engine: it
    has no 4x3 layout): zero torque from 0.45 m, 400 sim steps."""
    model = load_urdf(three_leg_urdf(str(tmp_path / "three_leg.urdf")))
    assert quadruped.quad_layout(model) is None
    geom = psim.default_contact_geometry(model)
    n = 2
    q = [dict(HipX=0.1, HipY=-1.0, Knee=1.8)[j.split("_")[1]]
         * (-1.0 if j.startswith("FR_HipX") else 1.0)
         for j in model.joint_names]
    state = make_state(n=n, pos_z=0.45, q=q, nq=model.nq)
    inertias, _ = engine.make_inertias(model, num_envs=n, device="cpu")
    anchors = psim.init_anchors(geom, n, device="cpu")
    tfn, sim, tau = flat_fn(), SimParams(), torch.zeros((model.nq, n))
    for _ in range(400):  # 2 s
        state, anchors, info = psim.sim_step(model, geom, sim, inertias,
                                             state, anchors, tau, tfn,
                                             torch.ones(n), torch.zeros(n))
    assert info["foot_pos"].shape == (3, 3, n)
    check_drop(state, info, model)
