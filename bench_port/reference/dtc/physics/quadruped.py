"""Leg-batched FK/ABA for quadrupeds on torch tensors.

Counterpart of the JAX package's physics/quadruped.py: a base plus 4
identical (HipX, HipY, Knee) chains, processed as a (..., 4, N) batch with
a depth loop of 3.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import quat as qm
from ..ops import spatial as sp
from ..robot.model import RobotModel
from .engine import SimParams, motion_axis


@dataclasses.dataclass(frozen=True)
class QuadLayout:
    """Static indexing of the 4x3 chain structure of a RobotModel."""
    body_idx: np.ndarray     # (3,4) dynamic-body index at [depth, leg]
    joint_idx: np.ndarray    # (3,4) joint (q column) index at [depth, leg]
    axis: np.ndarray         # (3,3) joint axis per depth
    r: np.ndarray            # (3,4,3) child origin per [depth, leg]


def quad_layout(model: RobotModel) -> QuadLayout | None:
    """Detect the quadruped structure; None if the model doesn't match."""
    if model.nb != 13:
        return None
    body_idx = np.zeros((3, 4), dtype=np.int32)
    joint_idx = np.zeros((3, 4), dtype=np.int32)
    axis = np.zeros((3, 3))
    r = np.zeros((3, 4, 3))
    for leg in range(4):
        chain = [1 + 3 * leg, 2 + 3 * leg, 3 + 3 * leg]
        if model.parent[chain[0]] != 0 or model.parent[chain[1]] != chain[0] \
                or model.parent[chain[2]] != chain[1]:
            return None
        for d, b in enumerate(chain):
            j = b - 1
            body_idx[d, leg] = b
            joint_idx[d, leg] = j
            r[d, leg] = model.joint_t[j]
            if leg == 0:
                axis[d] = model.joint_axis[j]
            elif not np.allclose(axis[d], model.joint_axis[j]):
                return None
            if not np.allclose(model.joint_R[j], np.eye(3)):
                return None
    return QuadLayout(body_idx=body_idx, joint_idx=joint_idx, axis=axis, r=r)


def fk(model: RobotModel, layout: QuadLayout, state: dict):
    """Leg-batched forward kinematics.

    Returns R (nb,3,3,N), x (nb,3,N), v (nb,6,N) (body velocity in body
    coords) plus the depth-batched internals the ABA reuses."""
    N = state["pos"].shape[-1]
    dev = state["pos"].device
    R0 = qm.quat_to_rotmat(state["quat"].movedim(0, -1)).movedim(0, -1)
    v0 = torch.cat([sp.rtmul(R0, state["ang_vel"]),
                    sp.rtmul(R0, state["lin_vel"])])           # (6,N)

    R_par = R0[:, :, None, :].expand(3, 3, 4, N)
    x_par = state["pos"][:, None, :].expand(3, 4, N)
    v_par = v0[:, None, :].expand(6, 4, N)

    R_depth, x_depth, v_depth, E_depth, r_depth = [], [], [], [], []
    for d in range(3):
        jidx = torch.as_tensor(layout.joint_idx[d], dtype=torch.long,
                               device=dev)
        q_cols = state["q"][jidx]                              # (4,N)
        dq_cols = state["qd"][jidx]
        Rj = sp.axis_rotation(layout.axis[d], q_cols)          # (3,3,4,N)
        E = Rj.transpose(0, 1)
        r = torch.as_tensor(layout.r[d].T, dtype=torch.float32,
                            device=dev)[:, :, None]            # (3,4,1)
        v = (sp.xm_apply(E, r, v_par)
             + motion_axis(layout.axis[d], dev)[:, None] * dq_cols[None])
        R = sp.mmul(R_par, Rj)
        x = x_par + sp.rmul(R_par, r.expand(3, 4, N))
        R_depth.append(R); x_depth.append(x); v_depth.append(v)
        E_depth.append(E); r_depth.append(r)
        R_par, x_par, v_par = R, x, v

    def gather_body(arrs, base):
        out = [base]
        for leg in range(4):
            for d in range(3):
                out.append(arrs[d][..., leg, :])
        return torch.stack(out)

    return dict(
        R=gather_body(R_depth, R0),
        x=gather_body(x_depth, state["pos"]),
        v=gather_body(v_depth, v0),
        E_depth=E_depth, r_depth=r_depth,
        R_depth=R_depth, v_depth=v_depth, v0=v0, R0=R0,
    )


def aba(model: RobotModel, layout: QuadLayout, inertias, kin, qd, tau,
        f_ext, sim: SimParams):
    """Leg-batched articulated-body algorithm.

    inertias (nb,6,6,N); qd/tau (nq,N); f_ext (nb,6,N) world-aligned at
    body origins.  Returns (qdd (nq,N), a0 (6,N))."""
    N = qd.shape[-1]
    dev = qd.device
    bidx = [torch.as_tensor(layout.body_idx[d], dtype=torch.long, device=dev)
            for d in range(3)]
    jidx = [torch.as_tensor(layout.joint_idx[d], dtype=torch.long, device=dev)
            for d in range(3)]
    I_depth = [inertias[bidx[d]].movedim(0, -2) for d in range(3)]  # (6,6,4,N)
    fx_depth = [f_ext[bidx[d]].movedim(0, -2) for d in range(3)]    # (6,4,N)
    qd_depth = [qd[jidx[d]] for d in range(3)]                      # (4,N)
    tau_depth = [tau[jidx[d]] for d in range(3)]
    S_depth = [motion_axis(layout.axis[d], dev)[:, None] for d in range(3)]

    IA, pA = [], []
    for d in range(3):
        v = kin["v_depth"][d]
        p_i = sp.crf(v, sp.imul(I_depth[d], v))
        Rb = kin["R_depth"][d]
        n_b = sp.rtmul(Rb, fx_depth[d][:3])
        f_b = sp.rtmul(Rb, fx_depth[d][3:])
        IA.append(I_depth[d])
        pA.append(p_i - torch.cat([n_b, f_b]))

    I0 = inertias[0]
    v0 = kin["v0"]
    pA0 = sp.crf(v0, sp.imul(I0, v0))
    n0 = sp.rtmul(kin["R0"], f_ext[0][:3])
    f0 = sp.rtmul(kin["R0"], f_ext[0][3:])
    pA0 = pA0 - torch.cat([n0, f0])
    IA0 = I0

    U = [None] * 3
    dinv = [None] * 3
    u = [None] * 3
    c = [sp.crm(kin["v_depth"][d], S_depth[d] * qd_depth[d][None])
         for d in range(3)]

    for d in (2, 1, 0):
        Sb = S_depth[d].expand(6, 4, N)
        Ui = sp.imul(IA[d], Sb)
        di = sp.dot_leading(Sb, Ui) + sim.armature
        ui = (tau_depth[d] - sim.joint_friction * qd_depth[d]
              - sp.dot_leading(Sb, pA[d]))
        U[d], dinv[d], u[d] = Ui, 1.0 / di, ui
        Ia = IA[d] - sp.outer_leading(Ui, Ui) * (1.0 / di)
        pa = pA[d] + sp.imul(Ia, c[d]) + Ui * (ui / di)
        E, r = kin["E_depth"][d], kin["r_depth"][d]
        Ia_p = sp.inertia_transform_to_parent(E, r, Ia)        # (6,6,4,N)
        pa_p = sp.xf_inv_apply(E, r, pa)                       # (6,4,N)
        if d > 0:
            IA[d - 1] = IA[d - 1] + Ia_p
            pA[d - 1] = pA[d - 1] + pa_p
        else:
            IA0 = IA0 + Ia_p.sum(dim=-2)
            pA0 = pA0 + pa_p.sum(dim=-2)

    a0 = -sp.solve_spd6(IA0, pA0)

    a_par = a0[:, None, :].expand(6, 4, N)
    qdd = torch.zeros_like(qd)
    for d in range(3):
        E, r = kin["E_depth"][d], kin["r_depth"][d]
        a_p = sp.xm_apply(E, r, a_par) + c[d]
        qdd_d = (u[d] - sp.dot_leading(U[d], a_p)) * dinv[d]
        a_par = a_p + S_depth[d] * qdd_d[None]
        qdd[jidx[d]] = qdd_d
    return qdd, a0
