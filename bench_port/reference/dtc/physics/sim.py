"""Contact geometry of a robot, its stiction anchors, and one plain
physics step.

Counterpart of the JAX package's physics/sim.py (ContactGeometry,
default_contact_geometry, init_anchors, sim_step).  `sim_step` is the
physics of every route off the decimation kernel (DTC_PALLAS_PHYSICS=0,
DTC_STRICT_PARITY=1, a plane, more than one substep, a robot that is not
a 4x3 quadruped): every contact point, body points included, samples the
terrain at every substep.  It steps a 4x3 quadruped through the
leg-batched FK/ABA (physics/quadruped.py) and any other revolute tree
through the generic engine (engine.fk/aba), as the JAX package's
sim_step does.  It is plain PyTorch on every device, as the JAX
package's XLA route has no Pallas kernel.  The default route steps
physics through the decimation kernel (physics/cuda_substep.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..robot.model import RobotModel
from . import engine, quadruped
from .engine import SimParams


@dataclasses.dataclass(frozen=True)
class ContactGeometry:
    """Static contact sample points for a robot: feet are the URDF spheres
    (Lite3.urdf:127-132); the other bodies are approximated by sample
    spheres."""
    dyn_idx: np.ndarray      # (P,) dynamic body of each point
    report_idx: np.ndarray   # (P,) reporting body for contact-force sums
    offset: np.ndarray       # (P,3) in body frame
    radius: np.ndarray       # (P,)
    eff_mass: np.ndarray     # (P,) effective mass for the implicit contact solve


def default_contact_geometry(model: RobotModel) -> ContactGeometry:
    dyn_idx, report_idx, offset, radius = [], [], [], []

    # feet (exact URDF spheres)
    for k in range(len(model.foot_body_index)):
        dyn_idx.append(int(model.foot_dyn_index[k]))
        report_idx.append(int(model.foot_body_index[k]))
        offset.append(model.foot_offset[k])
        radius.append(float(model.foot_radius[k]))

    # torso: 4 bottom corners + 4 top corners scaled from torso size
    torso_i = 0
    hx = float(np.max(np.abs(model.joint_t[0::3][:, 0]))) if model.nq >= 3 else 0.2
    hy = float(np.max(np.abs(model.joint_t[0::3][:, 1]))) + 0.02
    hz = 0.055
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                dyn_idx.append(torso_i)
                report_idx.append(0)
                offset.append(np.array([sx * hx, sy * hy, sz * hz]))
                radius.append(0.03)

    # knee point on each thigh (thigh tip) and mid-shank point
    for i, n in enumerate(model.dynamic_body_names):
        if "THIGH" in n:
            child = [k for k in range(1, model.nb) if model.parent[k] == i]
            if child:
                dyn_idx.append(i)
                report_idx.append(model.body_index(n))
                offset.append(model.joint_t[child[0] - 1].copy())
                radius.append(0.03)
        if "SHANK" in n:
            dyn_idx.append(i)
            report_idx.append(model.body_index(n))
            offset.append(np.array([0.02, 0.0, model.com[i][2] * 0.8]))
            radius.append(0.025)

    dyn_idx = np.array(dyn_idx, dtype=np.int32)
    eff_mass = np.maximum(model.mass[dyn_idx], 0.05).astype(np.float32)
    return ContactGeometry(
        dyn_idx=dyn_idx,
        report_idx=np.array(report_idx, dtype=np.int32),
        offset=np.stack(offset),
        radius=np.array(radius, dtype=np.float32),
        eff_mass=eff_mass,
    )


def init_anchors(geom: ContactGeometry, num_envs: int, device="cuda"):
    """Fresh stiction anchors (reset together with the physics state)."""
    return torch.zeros((len(geom.dyn_idx), 2, num_envs), dtype=torch.float32,
                       device=device)


def sim_step(model: RobotModel, geom: ContactGeometry, sim: SimParams,
             inertias, state: dict, anchors, tau, terrain_fn, friction,
             restitution):
    """Advance physics by sim.dt in sim.substeps substeps (the JAX
    package's sim.sim_step).

    tau (nq,N) joint torques held over the substeps; terrain_fn(x, y) maps
    (P,N) world coordinates to (height, dh/dx, dh/dy, h_max) (P,N) each.
    (The JAX package's optional base push force has no caller: pushes set
    the base velocity.)
    Returns (new_state, new_anchors, info): contact_forces (num_bodies,3,N)
    averaged over the substeps, foot_pos / foot_vel (nf,3,N) and the kin of
    the last substep."""
    nf = len(model.foot_body_index)
    dt = sim.dt / sim.substeps
    dev = state["q"].device

    def col(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)[:, None]
    lim_lo, lim_hi = col(model.pos_limit[:, 0]), col(model.pos_limit[:, 1])
    radius = torch.as_tensor(geom.radius, dtype=torch.float32, device=dev)
    eff_mass = torch.as_tensor(geom.eff_mass, dtype=torch.float32, device=dev)
    # the leg-batched FK/ABA for a 4x3 quadruped, else the generic engine
    layout = quadruped.quad_layout(model)
    contact_rep = None
    for _ in range(sim.substeps):
        q = state["q"]
        # joint-limit enforcement (PhysX enforces URDF limits natively)
        tau_lim = (sim.limit_stiffness * (torch.clamp(lim_lo - q, min=0.0)
                                          - torch.clamp(q - lim_hi, min=0.0))
                   - sim.limit_damping * state["qd"]
                   * ((q < lim_lo) | (q > lim_hi)))
        kin = (quadruped.fk(model, layout, state) if layout is not None
               else engine.fk(model, state))
        pts_pos, pts_vel = engine.body_point_state(kin, geom.dyn_idx,
                                                   geom.offset)
        terrain = terrain_fn(pts_pos[:, 0], pts_pos[:, 1])
        forces, anchors = engine.heightfield_contact(
            pts_pos, pts_vel, radius, eff_mass, anchors, terrain, friction,
            restitution, sim, dt)
        f_ext = engine.accumulate_body_forces(model.nb, geom.dyn_idx, kin,
                                              pts_pos, forces)
        if layout is not None:
            qdd, a0 = quadruped.aba(model, layout, inertias, kin,
                                    state["qd"], tau + tau_lim, f_ext, sim)
        else:
            qdd, a0 = engine.aba(model, inertias, kin, state["qd"],
                                 tau + tau_lim, f_ext, sim)
        state = engine.integrate(model, state, kin, qdd, a0, sim, dt)

        # reporting-body contact force sums, as static per-body adds
        zero = torch.zeros_like(forces[0])
        rep = []
        for b in range(model.num_bodies):
            acc = zero
            for p in range(len(geom.report_idx)):
                if geom.report_idx[p] == b:
                    acc = acc + forces[p]
            rep.append(acc)
        rep = torch.stack(rep)
        contact_rep = rep if contact_rep is None else contact_rep + rep
        foot_pos, foot_vel = pts_pos[:nf], pts_vel[:nf]

    info = dict(contact_forces=contact_rep / sim.substeps, foot_pos=foot_pos,
                foot_vel=foot_vel, kin=kin)
    return state, anchors, info
