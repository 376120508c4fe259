"""The contact solver's gates on the port (tests/test_contact_rim.py) and
the X30 standing (tests/test_x30.py `test_x30_standing`).

Same states, step counts, gains and thresholds as the JAX tests, at their
env counts (1 env on the rims, 2 for the X30).  The point gates (a loaded
point on a stone rim, the friction cone on a 0.4 slope, a step-down over
a stair edge) integrate one contact point through engine.heightfield_
contact alone: no FK or ABA runs there, so they run once.  The full-robot
gates run on both engines: the leg-batched FK/ABA and the generic one,
forced by making the port's quadruped detection find no layout (a
monkeypatch, a test-only device).  No JAX run.
"""
import numpy as np
import pytest
import torch

from deep_tracking_control_tpu_torch.physics import engine
from deep_tracking_control_tpu_torch.physics import sim as psim
from deep_tracking_control_tpu_torch.robot import quadrupeds
from deep_tracking_control_tpu_torch.terrain import grid as tgrid
from tests.test_torch_physics_gates import ENGINES, use_engine

SIM = engine.SimParams()
DT = SIM.dt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _point_sim(terrain_fn, x0, v0, mu, steps, mass=0.6, radius=0.0,
               ext_force=(0.0, 0.0, 0.0)):
    """Integrate one contact point under gravity + ext_force through the
    anchored penalty contact: the isolated foot-on-terrain system."""
    pos = _f32(x0).reshape(1, 3, 1)
    vel = _f32(v0).reshape(1, 3, 1)
    anchors = pos[:, :2, :]
    fr = torch.full((1,), mu, dtype=torch.float32)
    rest = torch.zeros((1,))
    g = _f32([0.0, 0.0, SIM.gravity]).reshape(1, 3, 1)
    fext = _f32(ext_force).reshape(1, 3, 1)
    rad, m_eff = _f32([radius]), _f32([mass])
    traj = []
    for _ in range(steps):
        f, anchors = engine.heightfield_contact(
            pos, vel, rad, m_eff, anchors,
            terrain_fn(pos[:, 0], pos[:, 1]), fr, rest, SIM, DT)
        acc = g + (f + fext) / mass
        vel = vel + DT * acc
        pos = pos + DT * vel
        traj.append(pos[0, :, 0])
    return pos[0, :, 0].numpy(), vel[0, :, 0].numpy(), torch.stack(traj).numpy()


def test_rim_hold_no_creep():
    """A point loaded ON the rim of a stone (strong edge slope under the
    contact normal) must hold its xy position for a full second."""
    # stone occupies x < 0 at h=0; hole at depth -2 for x > 0; the bilinear
    # cell at the rim produces a steep capped slope like the real grid
    def terrain_fn(x, y):
        h = torch.where(x < 0.0, torch.zeros_like(x),
                        torch.clamp(-x * 40.0, min=-2.0))
        dhdx = torch.where((x > -0.025) & (x < 0.05), torch.full_like(x, -3.0),
                           torch.zeros_like(x))
        h_max = torch.where(x < 0.05, torch.zeros_like(x), h)
        return h, dhdx, torch.zeros_like(x), h_max

    # start ON the stone 1 cm from the edge, pressed by half a robot weight
    p0, _, _ = _point_sim(terrain_fn, [-0.01, 0.0, -0.005], [0, 0, 0],
                          mu=1.0, steps=200, ext_force=(0.0, 0.0, -30.0))
    assert abs(p0[0] - (-0.01)) < 0.004, p0   # < 4 mm drift in 1 s
    assert abs(p0[1]) < 0.004, p0
    assert p0[2] > -0.02, p0                  # supported, not falling


def test_friction_cone_on_slope():
    """tan(theta)=0.4 incline: mu=0.2 slides down, mu=0.6 sticks."""
    def terrain_fn(x, y):
        h = -0.4 * x
        return h, torch.full_like(x, -0.4), torch.zeros_like(x), h + 0.02

    p_lo, _, _ = _point_sim(terrain_fn, [0.0, 0.0, -0.005], [0, 0, 0],
                            mu=0.2, steps=200)
    assert p_lo[0] > 0.05, p_lo               # slid noticeably downhill
    p_hi, v_hi, _ = _point_sim(terrain_fn, [0.0, 0.0, -0.005], [0, 0, 0],
                               mu=0.6, steps=200)
    assert abs(p_hi[0]) < 0.005, p_hi
    assert np.linalg.norm(v_hi[:2]) < 0.01, v_hi


def test_stair_edge_step_down_no_tunnel():
    """A point moving fast over a stair edge drops to the LOWER tread and
    stops there: it must not pass through either surface."""
    def terrain_fn(x, y):
        h = torch.where(x < 0.0, torch.zeros_like(x),
                        torch.full_like(x, -0.15))   # 15 cm riser at x=0
        return h, torch.zeros_like(x), torch.zeros_like(x), h

    # just past the edge at 1 m/s, falling 3 m/s (a hard touchdown on the
    # lower tread)
    p, _, traj = _point_sim(terrain_fn, [0.02, 0.0, 0.0], [1.0, 0.0, -3.0],
                            mu=0.6, steps=200)
    assert p[2] > -0.17, p                    # never below the lower tread
    assert p[2] < -0.10, p                    # settled ON the lower tread
    assert np.min(traj[:, 2]) > -0.20         # no transient tunneling


@pytest.mark.parametrize("engine_name", ENGINES)
def test_lite3_stands_on_stone_rims(engine_name, monkeypatch):
    """Full robot: Lite3 standing with front feet on stone rims (half-on,
    steep slope at the contact) holds pose for 1 s: no creep, no sink."""
    use_engine(engine_name, monkeypatch)
    model = quadrupeds.get_robot("lite3")
    geom = psim.default_contact_geometry(model)
    inertias, _ = engine.make_inertias(model, num_envs=1, device="cpu")
    N = 1

    # stones at the front-feet x (+0.18): rim passes through the foot
    # center line; hind feet on solid ground
    def terrain_fn(x, y):
        zero = torch.zeros_like(x)
        hole = (x > 0.18) & (x < 0.45)
        h = torch.where(hole, torch.full_like(x, -2.0), zero)
        dhdx = torch.where((x > 0.155) & (x < 0.23), torch.full_like(x, -3.0),
                           zero)
        # rim cells (within one cell of the edges) keep the stone-top max
        h_max = torch.where((x > 0.23) & (x < 0.40), h, zero)
        return h, dhdx, zero, h_max

    q0 = np.array([0.0, -0.934, 1.571] * 4, dtype=np.float32)
    quat = torch.zeros((4, N))
    quat[3] = 1.0
    phys = engine.make_state(
        pos=_f32([[0.0], [0.0], [0.335]]), quat=quat,
        lin_vel=torch.zeros((3, N)), ang_vel=torch.zeros((3, N)),
        q=_f32(q0)[:, None], qd=torch.zeros((12, N)))
    anchors = psim.init_anchors(geom, N, device="cpu")
    fr = torch.full((N,), 0.8)
    rest = torch.zeros((N,))
    kp = 30.0 * torch.ones((12, N))
    kd = 1.0 * torch.ones((12, N))
    goal = _f32(q0)[:, None]
    base_traj, foot_traj = [], []
    for _ in range(200):
        tau = kp * (goal - phys["q"]) - kd * phys["qd"]
        phys, anchors, info = psim.sim_step(model, geom, SIM, inertias, phys,
                                            anchors, tau, terrain_fn, fr, rest)
        base_traj.append(phys["pos"][:, 0])
        foot_traj.append(info["foot_pos"][:, :, 0])
    base_traj = torch.stack(base_traj).numpy()
    foot_traj = torch.stack(foot_traj).numpy()
    # base holds height (no sink through rims, no launch)
    assert base_traj[-1, 2] > 0.24, base_traj[-1]
    assert base_traj[-1, 2] < 0.40, base_traj[-1]
    # base xy creep < 3 cm over 1 s
    assert np.linalg.norm(base_traj[-1, :2]) < 0.03, base_traj[-1]
    # front feet (x ~ +0.18) never tunnel into the hole (z stays near 0)
    front = foot_traj[:, foot_traj[0, :, 0] > 0.05, :]
    assert np.min(front[..., 2]) > -0.08, np.min(front[..., 2])


@pytest.mark.parametrize("engine_name", ENGINES)
def test_x30_standing(engine_name, monkeypatch):
    """X30 with its PD gains stands on flat ground (31 kg robot)."""
    use_engine(engine_name, monkeypatch)
    model = quadrupeds.x30()
    geom = psim.default_contact_geometry(model)
    default_q = np.array([0.1, -0.715, 1.43] * 4, dtype=np.float32)
    n = 2
    pos = torch.zeros((3, n))
    pos[2] = 0.48
    quat = torch.zeros((4, n))
    quat[3] = 1.0
    state = engine.make_state(
        pos=pos, quat=quat, lin_vel=torch.zeros((3, n)),
        ang_vel=torch.zeros((3, n)),
        q=_f32(default_q)[:, None].expand(12, n).contiguous(),
        qd=torch.zeros((12, n)))
    inertias, _ = engine.make_inertias(model, num_envs=n, device="cpu")
    grid = tgrid.flat_grid(16.0, 0.05, "cpu")

    def tfn(x, y):
        return tgrid.height_and_slope(grid, x, y)
    anchors = psim.init_anchors(geom, n, device="cpu")
    kp = _f32([120.0, 120.0, 150.0] * 4)[:, None]
    kd = _f32([3.0, 3.0, 3.5] * 4)[:, None]
    qg = _f32(default_q)[:, None]
    eff = _f32(0.8 * model.effort_limit)[:, None]
    for _ in range(300):
        tau = torch.clamp(kp * (qg - state["q"]) - kd * state["qd"], -eff, eff)
        state, anchors, info = psim.sim_step(model, geom, SIM, inertias,
                                             state, anchors, tau, tfn,
                                             torch.ones(n), torch.zeros(n))
    z = state["pos"][2].numpy()
    assert np.all(z > 0.3) and np.all(z < 0.6), f"X30 standing height {z}"
    assert np.all(np.abs(state["quat"][3].numpy()) > 0.99)
    fz = info["contact_forces"][:, 2].sum(0).numpy()
    np.testing.assert_allclose(fz, model.mass.sum() * 9.81, rtol=0.3)
