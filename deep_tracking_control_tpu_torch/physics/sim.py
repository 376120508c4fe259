"""Contact geometry of a robot and its stiction anchors.

Counterpart of the JAX package's physics/sim.py (ContactGeometry,
default_contact_geometry, init_anchors).  Its XLA decimation path,
sim_step, has no counterpart here: the rollout steps physics through the
decimation kernel (physics/cuda_substep.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..robot.model import RobotModel


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
