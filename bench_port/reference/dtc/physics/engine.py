"""Articulated rigid-body physics on torch tensors.

Counterpart of the JAX package's physics/engine.py: per-env spatial
inertias with domain randomization, the generic forward kinematics and
articulated-body algorithm (`fk`, `aba`: Featherstone's recursions body by
body over any revolute tree the URDF reader accepts), the world state of
contact points, the anchored penalty contact, the per-body force sums and
the semi-implicit integration of the plain decimation loop (`integrate`,
for physics/sim.py `sim_step`; the decimation kernel,
physics/cuda_substep.py, integrates in the association of the TPU
kernel).  `sim_step` takes `fk`/`aba` wherever physics/quadruped.py finds
no 4x3 quadruped, as the JAX package does.  The JAX package runs this
engine as plain XLA, with no Pallas kernel, so here it is plain PyTorch on
every device: that is its port, not a fallback.  Layout: component axes
lead, the env batch axis trails (ops/spatial.py); the sums keep the JAX
package's association.
"""
from __future__ import annotations

import numpy as np
import torch

from ..env.config import SimParams  # noqa: F401  (re-exported)
from ..ops import quat as qm
from ..ops import spatial as sp
from ..robot.model import RobotModel


def make_state(pos, quat, lin_vel, ang_vel, q, qd) -> dict:
    return dict(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel, q=q, qd=qd)


def make_inertias(model: RobotModel, payload=None, com_disp=None,
                  link_mass_scale=None, num_envs: int | None = None,
                  device="cuda"):
    """Per-env spatial inertias (nb, 6, 6, N) with domain randomization and
    the per-env total mass (N,) (legged_robot.py:511-527, :1512)."""
    N = num_envs if num_envs is not None else (
        payload.shape[-1] if payload is not None else 1)
    f32 = torch.float32
    ones = torch.ones((N,), dtype=f32, device=device)
    inertias = []
    total_mass = torch.zeros((N,), dtype=f32, device=device)
    for i in range(model.nb):
        m = torch.as_tensor(model.mass[i], dtype=f32, device=device) * ones
        c = torch.as_tensor(model.com[i], dtype=f32, device=device)[:, None] * ones
        Ic = (torch.as_tensor(model.inertia[i], dtype=f32, device=device)
              [:, :, None] * ones)
        if i == 0:
            if payload is not None:
                m = m + payload
            if com_disp is not None:
                c = c + com_disp
        elif link_mass_scale is not None:
            m = m * link_mass_scale
            Ic = Ic * link_mass_scale
        total_mass = total_mass + m
        inertias.append(sp.spatial_inertia(m, c, Ic))
    return torch.stack(inertias), total_mass


def motion_axis(axis, device):
    """A revolute joint's motion subspace [axis; 0] as a (6, 1) column."""
    return torch.tensor([float(a) for a in axis] + [0.0, 0.0, 0.0],
                        dtype=torch.float32, device=device)[:, None]


def fk(model: RobotModel, state: dict):
    """Forward kinematics and velocities, body by body.

    Returns, per dynamic body b over nb: R (nb,3,3,N) body->world, x
    (nb,3,N) world origin, v (nb,6,N) spatial velocity in BODY coords;
    and per joint the child transform E (list of (3,3,N)) and origin r
    (list of (3,1)), None at the base."""
    N = state["pos"].shape[-1]
    dev = state["pos"].device
    R0 = qm.quat_to_rotmat(state["quat"].movedim(0, -1)).movedim(0, -1)
    w0_b = sp.rtmul(R0, state["ang_vel"])
    v0_b = sp.rtmul(R0, state["lin_vel"])
    R, x, v = [R0], [state["pos"]], [torch.cat([w0_b, v0_b])]
    E_list, r_list = [None], [None]
    for i in range(1, model.nb):
        j = i - 1
        p = int(model.parent[i])
        Rj = sp.axis_rotation(model.joint_axis[j], state["q"][j])  # (3,3,N)
        R_pc = torch.as_tensor(model.joint_R[j], dtype=torch.float32,
                               device=dev)[:, :, None].expand(3, 3, N)
        R_pc = sp.mmul(R_pc, Rj)              # child axes in parent coords
        E = R_pc.transpose(0, 1)              # parent -> child coords
        r = torch.as_tensor(model.joint_t[j], dtype=torch.float32,
                            device=dev)[:, None]
        vi = (sp.xm_apply(E, r, v[p])
              + motion_axis(model.joint_axis[j], dev) * state["qd"][j])
        R.append(sp.mmul(R[p], R_pc))
        x.append(x[p] + sp.rmul(R[p], r.expand(3, N)))
        v.append(vi)
        E_list.append(E)
        r_list.append(r)
    return dict(R=torch.stack(R), x=torch.stack(x), v=torch.stack(v),
                E=E_list, r=r_list)


def aba(model: RobotModel, inertias, kin, qd, tau, f_ext, sim: SimParams):
    """Featherstone's articulated-body algorithm, body by body.

    inertias (nb,6,6,N); qd, tau (nq,N); f_ext (nb,6,N) spatial forces on
    each body, world-aligned at the body origin ([torque; force]).
    Returns (qdd (nq,N), a0 (6,N)): the base's spatial acceleration in
    base coords, gravity taken as an apparent acceleration."""
    nb = model.nb
    v = kin["v"]
    N = v.shape[-1]
    dev = v.device
    S = [motion_axis(model.joint_axis[j], dev).expand(6, N)
         for j in range(nb - 1)]

    IA = [inertias[i] for i in range(nb)]
    pA = []
    for i in range(nb):
        vi = v[i]
        p_i = sp.crf(vi, sp.imul(IA[i], vi))
        # external force: world-aligned at the body origin -> body coords
        Rb = kin["R"][i]
        n_b = sp.rtmul(Rb, f_ext[i][:3])
        f_b = sp.rtmul(Rb, f_ext[i][3:])
        pA.append(p_i - torch.cat([n_b, f_b]))

    U, d, u, c = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    for i in range(1, nb):
        c[i] = sp.crm(v[i], S[i - 1] * qd[i - 1])      # v_i x (S qdot)

    # backward pass: articulated inertias and bias forces to the parents
    for i in range(nb - 1, 0, -1):
        j = i - 1
        p = int(model.parent[i])
        Ui = sp.imul(IA[i], S[j])
        di = sp.dot_leading(S[j], Ui) + sim.armature
        ui = ((tau[j] - sim.joint_friction * qd[j])
              - sp.dot_leading(S[j], pA[i]))
        U[i], d[i], u[i] = Ui, di, ui
        Ia = IA[i] - sp.outer_leading(Ui, Ui) / di
        pa = pA[i] + sp.imul(Ia, c[i]) + Ui * (ui / di)
        E, r = kin["E"][i], kin["r"][i]
        IA[p] = IA[p] + sp.inertia_transform_to_parent(E, r, Ia)
        pA[p] = pA[p] + sp.xf_inv_apply(E, r, pa)

    # the base: IA0 a0 = -pA0, by the unrolled LDL^T
    a0 = -sp.solve_spd6(IA[0], pA[0])

    a = [a0]
    qdd = []
    for i in range(1, nb):
        j = i - 1
        p = int(model.parent[i])
        a_p = sp.xm_apply(kin["E"][i], kin["r"][i], a[p]) + c[i]
        qdd_j = (u[i] - sp.dot_leading(U[i], a_p)) / d[i]
        a.append(a_p + S[j] * qdd_j)
        qdd.append(qdd_j)
    return torch.stack(qdd), a0


def body_point_state(kin, dyn_idx: np.ndarray, offsets: np.ndarray):
    """World position & velocity of fixed body-frame points: dyn_idx (P,),
    offsets (P,3) -> pos (P,3,N), vel (P,3,N)."""
    idx = torch.as_tensor(np.asarray(dyn_idx), dtype=torch.long,
                          device=kin["x"].device)
    Rb = kin["R"][idx]                # (P,3,3,N)
    xb = kin["x"][idx]                # (P,3,N)
    vb = kin["v"][idx]                # (P,6,N)
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.float32,
                          device=xb.device)[:, :, None].expand_as(xb)
    pos = xb + (Rb * off[:, None]).sum(dim=2)
    vel_b = vb[:, 3:] + sp.cross3(vb[:, :3].transpose(0, 1),
                                  off.transpose(0, 1)).transpose(0, 1)
    vel = (Rb * vel_b[:, None]).sum(dim=2)
    return pos, vel


def heightfield_contact(points_pos, points_vel, point_radius, point_eff_mass,
                        anchors, terrain, friction, restitution,
                        sim: SimParams, dt):
    """Anchored penalty contact of spheres against a heightfield.

    points_pos/vel (P,3,N); point_radius, point_eff_mass (P,) tensors;
    anchors (P,2,N) stiction anchors; terrain = (h, dh/dx, dh/dy, h_max)
    (P,N) each at the points; friction/restitution (N,).
    Returns (forces (P,3,N) world, new_anchors (P,2,N)).  Implicit normal
    spring-damper against the point's effective mass, stiction-anchor
    friction clipped to the cone, cliff-rim corner support — the solver of
    the JAX package's engine.heightfield_contact."""
    x, y, z = points_pos[:, 0], points_pos[:, 1], points_pos[:, 2]
    h, dhdx, dhdy, h_max = terrain
    zr = z - point_radius[:, None]

    cliff = ((torch.abs(dhdx) >= sim.cliff_threshold)
             | (torch.abs(dhdy) >= sim.cliff_threshold))
    near_top = (h_max - zr) < sim.cliff_active_depth
    cliff_sup = cliff & near_top
    h_eff = torch.where(cliff_sup, h_max, h)

    ncap = sim.normal_slope_cap
    zero = torch.zeros_like(h)
    gx = torch.where(cliff_sup, zero,
                     torch.where(cliff, dhdx, torch.clamp(dhdx, -ncap, ncap)))
    gy = torch.where(cliff_sup, zero,
                     torch.where(cliff, dhdy, torch.clamp(dhdy, -ncap, ncap)))
    nx, ny = -gx, -gy
    inv_norm = torch.rsqrt(nx * nx + ny * ny + 1.0)
    nx, ny, nz = nx * inv_norm, ny * inv_norm, inv_norm

    pen = h_eff - zr
    vx, vy, vz = points_vel[:, 0], points_vel[:, 1], points_vel[:, 2]
    vn = vx * nx + vy * ny + vz * nz

    active = (pen > 0.0) & (pen < 0.5)
    m_eff = point_eff_mass[:, None]
    damp = torch.where(vn < 0.0, torch.full_like(vn, sim.contact_damping),
                       sim.contact_damping * (1.0 - restitution))
    k = sim.contact_stiffness
    denom = 1.0 + (k * dt + damp) * dt / m_eff
    fn = (k * pen - (k * dt + damp) * vn) / denom
    fn = torch.clamp(fn, 0.0, sim.max_contact_force) * active

    kt, ct = sim.tangential_stiffness, sim.tangential_damping
    disp_x = x - anchors[:, 0]
    disp_y = y - anchors[:, 1]
    inv_t = 1.0 / (1.0 + (kt * dt + ct) * dt / m_eff)
    ft_x = -(kt * disp_x + ct * vx) * inv_t
    ft_y = -(kt * disp_y + ct * vy) * inv_t
    ft_mag = torch.sqrt(ft_x * ft_x + ft_y * ft_y + 1e-12)
    ft_max = friction * fn
    scale = torch.clamp(ft_max / ft_mag, max=1.0)
    ft_x = ft_x * scale * active
    ft_y = ft_y * scale * active

    slip = (scale < 1.0) & active
    new_ax = torch.where(active & ~slip, anchors[:, 0],
                         torch.where(slip, x + ft_x / kt, x))
    new_ay = torch.where(active & ~slip, anchors[:, 1],
                         torch.where(slip, y + ft_y / kt, y))
    new_anchors = torch.stack([new_ax, new_ay], dim=1)

    fx = nx * fn + ft_x
    fy = ny * fn + ft_y
    fz = nz * fn
    return torch.stack([fx, fy, fz], dim=1), new_anchors


def accumulate_body_forces(nb, point_dyn_idx: np.ndarray, kin,
                           points_pos, forces):
    """Sum world point forces into per-dynamic-body spatial forces (nb,6,N),
    world-aligned at each body origin."""
    out = []
    zero = torch.zeros((6,) + forces.shape[2:], dtype=forces.dtype,
                       device=forces.device)
    for b in range(nb):
        acc = zero
        for p in range(len(point_dyn_idx)):
            if int(point_dyn_idx[p]) != b:
                continue
            arm = points_pos[p] - kin["x"][b]
            f = forces[p]
            acc = acc + torch.cat([sp.cross3(arm, f), f])
        out.append(acc)
    return torch.stack(out)


def integrate(model: RobotModel, state: dict, kin, qdd, a0, sim: SimParams,
              dt):
    """Semi-implicit Euler step (the JAX package's engine.integrate): base
    twist from the apparent acceleration plus gravity, velocity clamps,
    joint rates clipped at the velocity limits, exponential-map
    orientation update."""
    R0 = kin["R"][0]
    pos = state["pos"]
    zero = torch.zeros_like(pos[0])
    g_b = sp.rtmul(R0, torch.stack([zero, zero,
                                    torch.full_like(zero, sim.gravity)]))
    a0_true = a0 + torch.cat([torch.zeros_like(g_b), g_b])
    v0 = kin["v"][0] + dt * a0_true
    w_w = torch.clamp(sp.rmul(R0, v0[:3]), -50.0, 50.0)
    v_w = torch.clamp(sp.rmul(R0, v0[3:]), -100.0, 100.0)

    qd = state["qd"] + dt * qdd
    vel_lim = torch.as_tensor(np.asarray(model.vel_limit), dtype=torch.float32,
                              device=qd.device)[:, None]
    qd = torch.maximum(torch.minimum(qd, vel_lim), -vel_lim)
    q = state["q"] + dt * qd
    pos = pos + dt * v_w
    quat_n = qm.quat_integrate(state["quat"].movedim(0, -1),
                               w_w.movedim(0, -1), dt)
    return make_state(pos, quat_n.movedim(-1, 0), v_w, w_w, q, qd)
