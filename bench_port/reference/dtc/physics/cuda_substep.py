"""The physics decimation step: the CUDA kernel csrc/substep.cu and its
plain version.

Replaces the JAX package's physics/pallas_substep.py `decimation_step`
(the Pallas kernels `_substep_kernel_fused` / `_substep_kernel`, body
`_substep_body`): all `decimation` physics substeps of one policy step in
one launch — PD torques with the joint-limit spring, leg-batched FK, the
contact points' world state, terrain under each point, the implicit
penalty normal + stiction-anchor friction with cliff/rim support, per-body
force sums, the leg-batched ABA with its 6x6 SPD base solve, and the
semi-implicit integration.

Terrain inside the step, as in the TPU kernel:
  * each FOOT samples bilinear height + slope from a 16x16-cell band of
    its env's 40x128-cell contact window (raw-table rows [r0+16, r0+56) of
    the env's patch), the band placed at substep 0 and clamped beyond its
    edge (pallas_substep.py:129-187);
  * each BODY point uses the plane (h0, dh/dx, dh/dy at x0, y0) sampled at
    the end of the previous step, frozen through the step (:534-541).

On the H100 the kernel is bound by the latency of one env's long serial
program (13-body recursions, data-dependent terrain reads, the ABA's 6x6
articulated inertias), with little parallelism at 4096 envs to hide it.
The design splits each env over a team of four lanes, one a leg: a lane
runs its leg's joints, FK chain, contact points (the owner table of
`pack_constants`), ABA backward and forward passes; every lane computes
the base, with the legs' articulated inertias and the torso points'
forces exchanged by warp shuffles and summed in the plain version's order.
32 envs a 128-thread block fill 128 of the 132 SMs at 4096 envs
(`launch_shape`).  The env-trailing (k, N) arrays are read coalesced as
they are, and every per-robot constant comes from one packed float32
table.

Two variants, as in the JAX package, one kernel template in csrc:
  * fused (`blocks` + `starts`; `_substep_kernel_fused`, the Pallas call
    at pallas_substep.py:755): each foot reads its cells straight from the
    blocked raw table, no window copy;
  * window (`window`; `_substep_kernel`, the Pallas call at :771): the
    feet read a materialized (N, 40, 128) contact window through its
    strides, so that a view of the patch copy (`patches[0][:, 16:56]`) and
    the window copy (ops/cuda_patch.py) go in without a copy.  The window
    holds the rows the fused variant reads, so the two agree bit for bit.
The window variant counts its launches apart, on
`decimation_step.window_launches`.

The same source builds in float64 (`dtc_decimation_step_f64`: the fused
variant with every state, parameter and result in double, the terrain and
constant tables the float32 ones): `decimation_step` takes it when given
float64 state, to hold the kernel's arithmetic to the plain version's in
double where float32 does not resolve a step to the budget (the X30's).
No route of the env calls it; its launches count on
`decimation_step.f64_launches`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import spatial as sp
from ..robot.model import RobotModel
from ..terrain.patch import gather_cells
from . import engine, quadruped
from .engine import SimParams
from .sim import ContactGeometry

WIN_R0, WIN_R = 16, 40     # contact window rows within the 64-row patch
WIN_C0, WIN_C = 0, 128
BAND = 16                  # per-foot band: 16x16 cells
_BAND_MAX = BAND - 1.001
THREADS = 128              # threads a block, a multiple of 32
LANES = 4                  # threads an env: one a leg

# packed constant table (float32), shared with csrc/substep.cu
C_LO, C_HI, C_TLIM, C_VLIM = 24, 36, 48, 60      # per joint (12 each)
C_AXIS, C_R, C_BODY, C_JOINT, C_THIGH = 72, 81, 117, 129, 141
C_PTS = 145                # then radius, eff_mass (P each), offset (3P),
                           # dyn_idx, report_idx, owner (P each)
MAX_POINTS, MAX_REPORT = 32, 32
MAX_LEG_POINTS, MAX_TORSO_POINTS = 3, 2 * LANES   # csrc MAXLP, LANES * MAXTS
_quad_models: dict = {}       # models whose quadruped layout was checked


def point_owners(layout, geom: ContactGeometry) -> np.ndarray:
    """Each contact point's lane and body: leg + LANES * (depth + 1) for a
    point on body `depth` of a leg, and for the torso's points the lanes in
    turn (the k-th torso point to lane k % LANES).  Raises unless every
    point lies on the torso or a leg, no foot on the torso, a lane holds at
    most MAX_LEG_POINTS points of its leg and the torso at most
    MAX_TORSO_POINTS."""
    body_depth = {int(layout.body_idx[d, leg]): (leg, d)
                  for d in range(3) for leg in range(4)}
    owner = np.zeros(len(geom.dyn_idx), dtype=np.int64)
    torso = 0
    for p, b in enumerate(geom.dyn_idx):
        if b == 0 and p >= 4:           # the 4 feet come first
            owner[p] = torso % LANES
            torso += 1
        elif int(b) in body_depth:
            leg, d = body_depth[int(b)]
            owner[p] = leg + LANES * (d + 1)
        else:
            raise ValueError(f"contact point {p} on body {b}: neither the "
                             f"torso nor a leg (a foot on the torso?)")
    per_leg = np.bincount(owner[owner >= LANES] % LANES, minlength=LANES)
    if per_leg.max() > MAX_LEG_POINTS or torso > MAX_TORSO_POINTS:
        raise ValueError(f"unsupported contact geometry: {per_leg.max()} "
                         f"points on a leg, {torso} on the torso")
    return owner


def _inv(x: float) -> float:
    """1/x rounded to float32 (the port's cuda_build.inv)."""
    return float(np.float32(1.0) / np.float32(x))


def pack_constants(model: RobotModel, geom: ContactGeometry, sim: SimParams,
                   thigh_dyn_idx, hs: float) -> np.ndarray:
    """The per-robot constant table the kernel reads (layout above)."""
    layout = quadruped.quad_layout(model)
    P = len(geom.dyn_idx)
    dt = sim.dt / sim.substeps
    c = np.zeros(C_PTS + 8 * P, dtype=np.float64)
    # scalars; products of Python floats are taken in double and rounded
    # once, as the plain version's scalar arithmetic does
    c[:20] = [dt, sim.gravity, sim.contact_stiffness, sim.contact_damping,
              sim.max_contact_force, sim.armature, sim.joint_friction,
              sim.limit_stiffness, sim.limit_damping,
              sim.tangential_stiffness, sim.tangential_damping,
              sim.normal_slope_cap, sim.cliff_threshold,
              sim.cliff_active_depth, hs, _inv(hs),
              sim.contact_stiffness * dt,
              (sim.tangential_stiffness * dt + sim.tangential_damping) * dt,
              _inv(sim.tangential_stiffness), dt * 0.5]
    # the cnq rows of the TPU kernel (pallas_substep.py:712-714)
    c[C_LO:C_LO + 12] = model.pos_limit[:, 0]
    c[C_HI:C_HI + 12] = model.pos_limit[:, 1]
    c[C_TLIM:C_TLIM + 12] = 0.8 * model.effort_limit
    c[C_VLIM:C_VLIM + 12] = model.vel_limit
    c[C_AXIS:C_AXIS + 9] = layout.axis.reshape(-1)
    c[C_R:C_R + 36] = layout.r.reshape(-1)
    c[C_BODY:C_BODY + 12] = layout.body_idx.reshape(-1)
    c[C_JOINT:C_JOINT + 12] = layout.joint_idx.reshape(-1)
    c[C_THIGH:C_THIGH + 4] = np.asarray(thigh_dyn_idx)
    # the cgeom rows (:715-716) and the point geometry
    o = C_PTS
    c[o:o + P] = geom.radius
    c[o + P:o + 2 * P] = geom.eff_mass
    c[o + 2 * P:o + 5 * P] = np.asarray(geom.offset).reshape(-1)
    c[o + 5 * P:o + 6 * P] = geom.dyn_idx
    c[o + 6 * P:o + 7 * P] = geom.report_idx
    c[o + 7 * P:o + 8 * P] = point_owners(layout, geom)
    return c.astype(np.float32)


def _band_bilinear(window_cells, fr, fc, band_r, band_c, hs):
    """Bilinear height + slope + max corner of each foot from its band
    (pallas_substep.py:150-187).  fr/fc (nf,N) window cell coords; band_r/
    band_c (nf,N) the band's first window row/col (multiples of 8);
    window_cells(rows, cols) the (N, nf) values at (N, nf) window cells."""
    lfr = torch.clamp(fr - band_r, 0.0, _BAND_MAX)
    lfc = torch.clamp(fc - band_c, 0.0, _BAND_MAX)
    i0 = torch.floor(lfr)
    j0 = torch.floor(lfc)
    tx = lfr - i0
    ty = lfc - j0
    rows = (band_r + i0).long().T                   # (N, nf) window rows
    cols = (band_c + j0).long().T

    def cell(di, dj):
        return window_cells(rows + di, cols + dj).T
    c00, c10, c01, c11 = cell(0, 0), cell(1, 0), cell(0, 1), cell(1, 1)
    hgt = (c00 * (1.0 - tx) * (1.0 - ty) + c10 * tx * (1.0 - ty)
           + c01 * (1.0 - tx) * ty + c11 * tx * ty)
    dx = ((c10 - c00) * (1.0 - ty) + (c11 - c01) * ty) / hs
    dy = ((c01 - c00) * (1.0 - tx) + (c11 - c10) * tx) / hs
    h_max = torch.maximum(torch.maximum(c00, c10), torch.maximum(c01, c11))
    cap = 3.0
    return hgt, torch.clamp(dx, -cap, cap), torch.clamp(dy, -cap, cap), h_max


def _quat_integrate_t(q, w, dt):
    """Exponential-map integration, env-last ((4,N), (3,N)), in the
    association of the TPU kernel (pallas_substep.py:74-92)."""
    angle = torch.sqrt(w[0] ** 2 + w[1] ** 2 + w[2] ** 2)
    inv = 1.0 / torch.clamp(angle, min=1e-9)
    half = angle * (dt * 0.5)
    si = torch.sin(half) * inv
    c = torch.cos(half)
    ax, ay, az, aw = w[0] * si, w[1] * si, w[2] * si, c
    bx, by, bz, bw = q[0], q[1], q[2], q[3]
    out = torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])
    norm = torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2)
    return out / torch.clamp(norm, min=1e-9)


def decimation_step_plain(model: RobotModel, geom: ContactGeometry,
                          sim: SimParams, decimation: int, thigh_dyn_idx,
                          inertias, phys, anchors, goals, kp_eff, kd_eff,
                          strengths, offsets, friction, restitution,
                          win_origin, planes, hs, blocks=None, starts=None,
                          window=None):
    """Plain PyTorch version of the kernel (same arguments and results as
    `decimation_step`)."""
    layout = quadruped.quad_layout(model)
    dev = phys["pos"].device
    f32 = torch.float32
    nf = len(model.foot_body_index)
    dt = sim.dt / sim.substeps

    def col(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=dev)[:, None]
    lim_lo, lim_hi = col(model.pos_limit[:, 0]), col(model.pos_limit[:, 1])
    tau_lim, vel_lim = col(0.8 * model.effort_limit), col(model.vel_limit)
    radius = torch.as_tensor(geom.radius, dtype=f32, device=dev)
    eff_mass = torch.as_tensor(geom.eff_mass, dtype=f32, device=dev)
    if window is None:
        raw = blocks[0]

        def window_cells(rows, cols):
            return gather_cells(raw, starts, WIN_R0 + rows, WIN_C0 + cols)
    else:
        envs = torch.arange(window.shape[0], device=dev)[:, None]

        def window_cells(rows, cols):
            return window[envs, rows, cols]

    q, qd = phys["q"], phys["qd"]
    pos, quat = phys["pos"], phys["quat"]
    lin_vel, ang_vel = phys["lin_vel"], phys["ang_vel"]
    band_r = band_c = None
    for s in range(decimation * sim.substeps):
        # PD torques (legged_robot.py:595-630) + joint-limit spring
        tau = kp_eff * (goals[s] - q + offsets) - kd_eff * qd
        tau = torch.maximum(torch.minimum(tau * strengths, tau_lim), -tau_lim)
        tl = (sim.limit_stiffness * (torch.clamp(lim_lo - q, min=0.0)
                                     - torch.clamp(q - lim_hi, min=0.0))
              - sim.limit_damping * qd * ((q < lim_lo) | (q > lim_hi)))
        state = dict(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel,
                     q=q, qd=qd)
        kin = quadruped.fk(model, layout, state)
        pts_pos, pts_vel = engine.body_point_state(kin, geom.dyn_idx,
                                                   geom.offset)

        # feet: bilinear from the band placed at substep 0
        fr = (pts_pos[:nf, 0] - win_origin[0]) / hs
        fc = (pts_pos[:nf, 1] - win_origin[1]) / hs
        if s == 0:
            band_r = torch.clamp(torch.floor((fr - 2.0) / 8.0), 0,
                                 (WIN_R - BAND) // 8) * 8.0
            band_c = torch.clamp(torch.floor((fc - 2.0) / 8.0), 0,
                                 (WIN_C - BAND) // 8) * 8.0
        hf, gxf, gyf, hmf = _band_bilinear(window_cells, fr, fc, band_r,
                                           band_c, hs)
        # body points: the frozen planes (h0, gx, gy, x0, y0)
        xb, yb = pts_pos[nf:, 0], pts_pos[nf:, 1]
        hp = planes[:, 0] + planes[:, 1] * (xb - planes[:, 3]) \
            + planes[:, 2] * (yb - planes[:, 4])
        terrain = (torch.cat([hf, hp]), torch.cat([gxf, planes[:, 1]]),
                   torch.cat([gyf, planes[:, 2]]), torch.cat([hmf, hp]))
        forces, anchors = engine.heightfield_contact(
            pts_pos, pts_vel, radius, eff_mass, anchors, terrain, friction,
            restitution, sim, dt)
        f_ext = engine.accumulate_body_forces(model.nb, geom.dyn_idx, kin,
                                              pts_pos, forces)
        qdd, a0 = quadruped.aba(model, layout, inertias, kin, qd, tau + tl,
                                f_ext, sim)

        # semi-implicit integration (the JAX package's engine.integrate)
        R0 = kin["R0"]
        g_b = sp.rtmul(R0, torch.stack([torch.zeros_like(pos[0]),
                                        torch.zeros_like(pos[0]),
                                        torch.full_like(pos[0], sim.gravity)]))
        v0 = kin["v0"] + dt * (a0 + torch.cat([torch.zeros_like(g_b), g_b]))
        w_w = torch.clamp(sp.rmul(R0, v0[:3]), -50.0, 50.0)
        v_w = torch.clamp(sp.rmul(R0, v0[3:]), -100.0, 100.0)
        qd = qd + dt * qdd
        qd = torch.maximum(torch.minimum(qd, vel_lim), -vel_lim)
        q = q + dt * qd
        pos = pos + dt * v_w
        quat = _quat_integrate_t(quat, w_w, dt)
        lin_vel, ang_vel = v_w, w_w

    # reporting mirrors the last substep (pallas_substep.py:620-643)
    rep = []
    for b in range(model.num_bodies):
        acc = torch.zeros_like(forces[0])
        for p in range(len(geom.report_idx)):
            if geom.report_idx[p] == b:
                acc = acc + forces[p]
        rep.append(acc)
    thigh = torch.as_tensor(np.asarray(thigh_dyn_idx), dtype=torch.long,
                            device=dev)
    phys_n = dict(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel,
                  q=q, qd=qd)
    info = dict(contact_forces=torch.stack(rep) / sim.substeps,
                foot_pos=pts_pos[:nf], foot_vel=pts_vel[:nf],
                thigh_pos=kin["x"][thigh], torques=tau,
                body_pts=pts_pos[nf:])
    return phys_n, anchors, info


def decimation_step(model: RobotModel, geom: ContactGeometry, sim: SimParams,
                    decimation: int, thigh_dyn_idx, inertias, phys, anchors,
                    goals, kp_eff, kd_eff, strengths, offsets, friction,
                    restitution, win_origin, planes, hs, blocks=None,
                    starts=None, consts=None, window=None):
    """Run `decimation` physics substeps in one launch.

    All array args are env-LAST:
      phys: dict(pos (3,N), quat (4,N), lin_vel, ang_vel, q (nq,N), qd)
      anchors (P,2,N); inertias (nb,6,6,N)
      goals (decimation, nq, N) PD joint-position targets
      kp_eff/kd_eff/strengths/offsets (nq,N); friction/restitution (N,)
      win_origin (2, N) world xy of contact-window cell (0,0)
      planes (P-nf, 5, N) frozen local planes for body points
      blocks (T, B, R_pad, 128) the blocked terrain tables (raw = [0]) and
      starts (N, 2) int32 (terrain/patch.py patch_starts): the fused
      variant; OR window (N, 40, 128) float32 raw-table rows [r0+16,
      r0+56) of each env's column block, any strides: the window variant
      consts: the packed constant table on the card (pack_constants);
      built when None
    Returns (phys', anchors', info) with info = contact_forces (nrb,3,N),
    foot_pos / foot_vel (nf,3,N), thigh_pos (4,3,N), torques (nq,N) and
    body_pts (P-nf,3,N), all of the last substep.  CPU tensors take the
    plain version; CUDA tensors launch the kernel: its float64 build where
    the state is float64 (fused variant; blocks and consts float32)."""
    if (window is None) == (blocks is None or starts is None):
        raise ValueError("give either blocks and starts, or window")
    args = (model, geom, sim, decimation, thigh_dyn_idx, inertias, phys,
            anchors, goals, kp_eff, kd_eff, strengths, offsets, friction,
            restitution, win_origin, planes, hs, blocks, starts, window)
    dev = phys["pos"].device
    return decimation_step_plain(*args)

# the launch counts, fused and window variant and the float64 build: plain
# integers on the public wrapper, counted through this fixed reference (a
# caller may wrap the module attribute)
