"""Articulated rigid-body physics pieces on torch tensors.

Counterpart of the JAX package's physics/engine.py for the quadruped
path: per-env spatial inertias with domain randomization, the world state
of contact points, the anchored penalty contact, the per-body force sums
and the semi-implicit integration of the plain decimation loop
(`integrate`, for physics/sim.py sim_step; the decimation step,
physics/cuda_substep.py, integrates in the association of the TPU
kernel).  Layout: component axes lead, the env batch axis trails (ops/spatial.py).
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
