"""DTC foothold planner, plain PyTorch, with its debug outputs.

Counterpart of the JAX package's env/planner.py (parity with the planner
block of LeggedRobotDTC.post_physics_step, legged_robot_dtc.py:100-204):
nominal footholds from the shoulder projection + Raibert-style symmetry,
terrain scoring (slope/roughness/edge), distance to nominal, argmin
selection per leg, and the 8-d foothold observation.  The rollout uses
env/cuda_planner.py; this version also returns the full score tensor for
debug visualisation.  All arrays are env-leading (N, ...).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import quat as qm


def rotate_positions_z(vecs, thetas):
    """Rotate (N,4,3) vectors about z by per-env angles (N,)
    (legged_robot_dtc.py:36-54)."""
    c = torch.cos(thetas)[:, None]
    s = torch.sin(thetas)[:, None]
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)


def scan_gradients(g, ny: int, spacing: float = 0.05):
    """d/dx, d/dy of the flat (N, H) scan grid (rows of ny points): central
    inside, one-sided at the edges (torch.gradient semantics)."""
    dx = torch.cat(
        [(g[:, ny:2 * ny] - g[:, :ny]) / spacing,
         (g[:, 2 * ny:] - g[:, :-2 * ny]) / (2 * spacing),
         (g[:, -ny:] - g[:, -2 * ny:-ny]) / spacing], dim=1)
    up = torch.cat([g[:, 1:], g[:, -1:]], dim=1)
    dn = torch.cat([g[:, :1], g[:, :-1]], dim=1)
    j = torch.arange(g.shape[1], device=g.device) % ny
    dy = torch.where(j == 0, (up - g) / spacing,
                     torch.where(j == ny - 1, (g - dn) / spacing,
                                 (up - dn) / (2 * spacing)))
    return dx, dy


def plan_footholds(cfg, base_pos, base_quat, base_lin_vel, commands,
                   hip_positions, measured_heights, height_points,
                   measured_points_x, measured_points_y):
    """Optimal-foothold observation and world targets.

    base_pos (N,3) world; base_quat (N,4) xyzw; base_lin_vel (N,3) body
    frame; commands (N,4); hip_positions (N,4,3) world thigh positions;
    measured_heights (N,H) world z at the scan points; height_points (H,3)
    base-frame scan grid.  Returns dict(foothold_obs (N,8),
    optimal_footholds_world (N,4,3), foothold_score (N,H,4),
    heights_world (N,H,3), pred_footholds (N,4,3))."""
    N = base_pos.shape[0]
    nx = len(measured_points_x)
    ny = len(measured_points_y)
    dev = base_pos.device

    # nominal footholds (legged_robot_dtc.py:103-115)
    hip_to_base = hip_positions - base_pos[:, None, :]
    p_shoulder = base_pos[:, None, :] + rotate_positions_z(hip_to_base,
                                                           commands[:, 2])
    t_stance = cfg.dt
    cmd_lin_vel = torch.cat([commands[:, :2],
                             torch.zeros((N, 1), dtype=commands.dtype,
                                         device=dev)], dim=1)
    v = base_lin_vel[:, None, :]
    p_symmetric = t_stance / 2.0 * v + 0.03 * (v - cmd_lin_vel[:, None, :])
    pred_footholds = p_shoulder + p_symmetric

    # terrain scoring (legged_robot_dtc.py:124-148)
    rel = measured_heights - base_pos[:, 2:3]
    exception = (rel > 1.0) | (rel < -1.0)
    g = torch.clamp(rel, -0.5, 0.5)
    dx, dy = scan_gradients(g, ny)
    slope = torch.sqrt(dx * dx + dy * dy)
    h_mean = torch.mean(g, dim=1, keepdim=True)
    roughness = torch.abs(g - h_mean)
    edge = torch.clamp(torch.sqrt(torch.var(g, dim=1, correction=0)), 0.0, 0.3)
    score = 0.2 * edge[:, None] + 1.0 * slope + 0.3 * roughness
    score = torch.where(score < 0.1, score, torch.full_like(score, 10.0))

    # world-frame scan points (:152-156)
    hp = torch.as_tensor(np.asarray(height_points), dtype=base_pos.dtype,
                         device=dev)
    cy, sy = qm.yaw_rot2d(base_quat)
    hw_x = (cy[:, None] * hp[None, :, 0] - sy[:, None] * hp[None, :, 1]
            + base_pos[:, 0:1])
    hw_y = (sy[:, None] * hp[None, :, 0] + cy[:, None] * hp[None, :, 1]
            + base_pos[:, 1:2])
    heights_world = torch.stack([hw_x, hw_y, measured_heights], dim=-1)

    # distance to nominal per leg (:158-170)
    ddx = pred_footholds[:, :, None, 0] - hw_x[:, None, :]
    ddy = pred_footholds[:, :, None, 1] - hw_y[:, None, :]
    dis = torch.sqrt(ddx * ddx + ddy * ddy)
    dis = torch.where(dis < 0.16, dis, torch.full_like(dis, 10.0))
    total = score[:, None, :] * 0.2 + dis * 0.8
    total = torch.where(exception[:, None, :], torch.full_like(total, 10.0),
                        total)

    # argmin per leg (ktop=1, :179-201); first occurrence like jnp.argmin
    opt_idx = first_argmin(total)                                # (N,4)
    x_idx = torch.remainder(opt_idx, ny)
    y_idx = opt_idx // ny
    mpx = torch.as_tensor(measured_points_x, dtype=base_pos.dtype, device=dev)
    mpy = torch.as_tensor(measured_points_y, dtype=base_pos.dtype, device=dev)
    # the reference's tiled-table decode (legged_robot_dtc.py:184-192),
    # reproduced as the JAX package does: x_table[i % 21], y_table[(i//21) % 21]
    foothold_obs = torch.cat([mpx[x_idx % nx], mpy[y_idx % ny]], dim=1)
    optimal_footholds_world = torch.stack(
        [torch.gather(hw_x, 1, opt_idx), torch.gather(hw_y, 1, opt_idx),
         torch.gather(measured_heights, 1, opt_idx)], dim=-1)
    return dict(foothold_obs=foothold_obs,
                optimal_footholds_world=optimal_footholds_world,
                foothold_score=total.transpose(1, 2),
                heights_world=heights_world,
                pred_footholds=pred_footholds)


def first_argmin(total):
    """Index of the first minimum over the last axis (jnp.argmin
    semantics; torch.argmin does not promise the first of equal minima)."""
    m = torch.amin(total, dim=-1, keepdim=True)
    H = total.shape[-1]
    lane = torch.arange(H, device=total.device)
    return torch.amin(torch.where(total == m, lane, H), dim=-1)
