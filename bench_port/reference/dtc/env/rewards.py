"""Reward terms on torch tensors.

Counterpart of the JAX package's env/rewards.py (parity with
legged_robot.py:1320-1622, where for a twice-defined term the last
definition wins, and the DTC terms of legged_robot_dtc.py:522-586).  Each
term is fn(ctx) -> (N,), where ctx is a dict of step quantities in the
env-leading layout.  Stateful terms (feet_air_time, foot_clearance's
stumble ring buffer, orientation's pitch filter) read their previous
state from ctx and write updates into ctx["updates"].  Scales are
multiplied by dt by the caller (legged_robot.py:939).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import quat as qm


def _norm(x, dim=-1):
    return torch.linalg.vector_norm(x, dim=dim)


def _plane_norm(ctx):
    # X = pinv(A) @ heights with A = [x, y, 1] over the scan grid
    X = ctx["measured_heights"] @ ctx["plane_pinv"].T           # (N,3)
    plane = torch.stack([X[:, 0], X[:, 1], -torch.ones_like(X[:, 0])], dim=1)
    return plane / _norm(plane)[:, None]


def _orientation_common(ctx):
    p_norm = -_plane_norm(ctx)
    pitch_est = torch.atan(p_norm[:, 0])
    roll_est = -torch.atan(p_norm[:, 1])
    zero = torch.zeros_like(pitch_est)
    pitch_clip = torch.where((pitch_est >= -0.1) & (pitch_est <= 0.1), zero,
                             pitch_est)
    roll_clip = torch.where((roll_est >= -0.1) & (roll_est <= 0.1), zero,
                            roll_est)
    new_pitch = ctx["pitch_est"] * 0.2 + 0.8 * pitch_clip
    ctx["updates"]["pitch_est"] = new_pitch
    quat = qm.quat_from_euler_xyz(roll_clip, new_pitch, zero)
    gvec = torch.tensor([0.0, 0.0, -1.0], dtype=quat.dtype,
                        device=quat.device).expand(quat.shape[:-1] + (3,))
    return qm.quat_rotate_inverse(quat, gvec)


def reward_orientation(ctx):
    p_local = _orientation_common(ctx)
    return torch.sum(torch.square(ctx["projected_gravity"][:, :1]
                                  - p_local[:, :1]), dim=1)


def reward_orientation_roll(ctx):
    p_local = _orientation_common(ctx)
    return torch.abs(ctx["projected_gravity"][:, 1] - p_local[:, 1])


def reward_lin_vel_z(ctx):
    return torch.square(ctx["base_lin_vel"][:, 2])


def reward_ang_vel_xy(ctx):
    return torch.sum(torch.square(ctx["base_ang_vel"][:, :2]), dim=1)


def reward_torques(ctx):
    return torch.sum(torch.square(ctx["torques"]), dim=1)


def reward_dof_vel(ctx):
    return torch.sum(torch.square(ctx["dof_vel"]), dim=1)


def reward_dof_acc(ctx):
    return torch.sum(torch.square((ctx["last_dof_vel"] - ctx["dof_vel"])
                                  / ctx["dt"]), dim=1)


def reward_action_rate(ctx):
    return torch.sum(torch.square(ctx["last_actions"] - ctx["actions"]), dim=1)


def reward_collision(ctx):
    cf = ctx["contact_forces"][:, ctx["penalised_idx"]]          # (N,K,3)
    return torch.sum(1.0 * (_norm(cf) > 0.1), dim=1)


def reward_termination(ctx):
    return (ctx["reset_buf"] & ~ctx["time_out_buf"]).float()


def reward_dof_pos_limits(ctx):
    q = ctx["dof_pos"]
    lo, hi = ctx["soft_dof_pos_limits"]
    out = -torch.clamp(q - lo, max=0.0) + torch.clamp(q - hi, min=0.0)
    return torch.sum(out, dim=1)


def reward_dof_vel_limits(ctx):
    lim = ctx["dof_vel_limit"] * ctx["soft_dof_vel_limit"]
    return torch.sum(torch.clamp(torch.abs(ctx["dof_vel"]) - lim, 0.0, 1.0),
                     dim=1)


def reward_torque_limits(ctx):
    lim = ctx["torque_limit"] * ctx["soft_torque_limit"]
    return torch.sum(torch.clamp(torch.abs(ctx["torques"]) - lim, min=0.0),
                     dim=1)


def reward_tracking_lin_vel(ctx):
    err = torch.sum(torch.square((ctx["commands"][:, :2]
                                  - ctx["base_lin_vel"][:, :2])
                                 / ctx["lin_vel_x_max"]), dim=1)
    return torch.exp(-err / ctx["tracking_sigma"])


def reward_tracking_ang_vel(ctx):
    err = torch.square(ctx["commands"][:, 2] - ctx["base_ang_vel"][:, 2])
    return torch.exp(-err / ctx["tracking_sigma"])


def reward_feet_air_time(ctx):
    """Stateful: reads/updates feet_air_time (legged_robot.py:1386-1414)."""
    contact = ctx["feet_contact"]
    contact_filt = contact | ctx["last_contacts"]
    air = ctx["feet_air_time"]
    first_contact = (air > 0.0) & contact_filt
    air = air + ctx["dt"]
    rew = torch.sum((air - 0.5) * first_contact, dim=1)
    rew = rew * (_norm(ctx["commands"][:, :2]) > 0.1)
    ctx["updates"]["feet_air_time"] = air * ~contact_filt
    return rew


def reward_stumble(ctx):
    cf = ctx["contact_forces"][:, ctx["feet_idx"]]
    return torch.any(_norm(cf[:, :, :2]) > 5.0 * torch.abs(cf[:, :, 2]),
                     dim=1).float()


def reward_stand_still(ctx):
    return (torch.sum(torch.abs(ctx["dof_pos"] - ctx["default_dof_pos"]),
                      dim=1)
            * (_norm(ctx["commands"][:, :2]) < 0.1))


def reward_feet_contact_forces(ctx):
    cf = ctx["contact_forces"][:, ctx["feet_idx"]]
    return torch.sum(torch.clamp(_norm(cf) - ctx["max_contact_force"],
                                 min=0.0), dim=1)


def reward_power(ctx):
    return torch.sum(torch.clamp(ctx["torques"] * ctx["dof_vel"], min=0.0),
                     dim=1)


def reward_smooth(ctx):
    return torch.sum(torch.square(ctx["actions"] - 2.0 * ctx["last_actions"]
                                  + ctx["last_actions_2"]), dim=1)


def reward_foot_clearance(ctx):
    """Stateful via the 5-deep stumble ring buffer (legged_robot.py:1474-1492)."""
    cf = ctx["contact_forces"][:, ctx["feet_idx"]]
    stumb = _norm(cf[:, :, :2]) > 4.0 * torch.abs(cf[:, :, 2])   # (N,4)
    buf = torch.cat([ctx["stumb_buffer"][:, 1:], stumb[:, None, :]], dim=1)
    ctx["updates"]["stumb_buffer"] = buf
    flag = torch.any(buf, dim=1)
    clear = ctx["measured_foot_clearance"]
    return torch.sum((~flag) & (clear > 0.18), dim=1).float()


def reward_feet_slip(ctx):
    contact_filt = ctx["feet_contact"] | ctx["last_contacts"]
    fv = torch.square(_norm(ctx["foot_velocities"][:, :, 0:2]))
    return torch.sum(contact_filt * fv, dim=1)


def reward_hip_pos(ctx):
    return torch.sum(torch.square(ctx["dof_pos"][:, ctx["hip_dof_idx"]]),
                     dim=1)


def reward_powerchange(ctx):
    smooth_co = torch.clamp(ctx["commands"][:, 0], min=1.0)
    p = torch.sum(torch.clamp(ctx["torques"] * ctx["dof_vel"], min=0.0),
                  dim=1)
    return torch.square(p / (ctx["robot_mass"] * 9.815 * smooth_co))


def reward_pos_acc(ctx):
    pts = ctx["acc_points"]                                       # (8,3)
    v = ctx["base_lin_vel"][:, None, :]
    w = ctx["base_ang_vel"][:, None, :].expand(-1, pts.shape[0], 3)
    pv = v + torch.linalg.cross(w, pts.expand_as(w), dim=-1)
    return torch.sum(torch.square(_norm(pv)), dim=1)


def reward_foot_acc(ctx):
    mask = torch.where(ctx["terrain_levels"] > 5, 0.2, 1.0)[:, None]
    acc = _norm((ctx["last_foot_velocities"] - ctx["foot_velocities"])
                / ctx["dt"])
    return torch.sum(torch.clamp(mask * (acc - ctx["max_acc"]), min=0.0),
                     dim=1)


def reward_big_pitch(ctx):
    return torch.sum(torch.abs(ctx["projected_gravity"][:, 0:1]) > 0.6,
                     dim=1).float()


def reward_feet_stumble(ctx):
    cf = ctx["contact_forces"][:, ctx["feet_idx"]]
    return torch.any(_norm(cf[:, :, :2]) > 3.0 * torch.abs(cf[:, :, 2]),
                     dim=1).float()


def reward_base_height(ctx):
    foot_to_body = ctx["root_z"] - torch.mean(ctx["foot_positions"][:, :, 2],
                                              dim=-1)
    return torch.square(foot_to_body - ctx["base_height_target"])


def reward_foothold_miss(ctx):
    # below the env-origin height = missed foothold (dtc.py:536-539, with
    # the JAX package's origin-relative line)
    min_z = torch.amin(ctx["foot_positions"][:, :, 2], dim=-1)
    return (min_z < ctx["env_origin_z"]).float()


def reward_soft_tracking_lin_vel(ctx, tolerance=0.0, lookback=3):
    # reference indexing (legged_robot_dtc.py:547): commands over the last
    # `lookback` steps against the velocity at the single step -lookback
    cmd = ctx["cmd_buffer"][:, -lookback:, :2]
    vel = ctx["lin_vel_buffer"][:, -lookback, :2][:, None, :]
    d = torch.sum(torch.square((cmd - vel) / ctx["lin_vel_x_max"]), dim=-1)
    return torch.mean(torch.exp(-d / ctx["tracking_sigma"]), dim=1)


def reward_soft_tracking_ang_vel(ctx, tolerance=0.15, lookback=4):
    cmd = ctx["cmd_buffer"][:, -lookback:, 2]
    ang = ctx["ang_vel_buffer"][:, -lookback:, 0]
    d = torch.square((cmd - ang) / ctx["ang_vel_yaw_max"])
    d = torch.where(d <= tolerance ** 2, 0.0, 1.0)
    return torch.mean(torch.exp(-d / ctx["tracking_sigma"]), dim=1)


def reward_tracking_optimal_footholds(ctx):
    dis = _norm(ctx["foot_positions"][:, :, :2]
                - ctx["optimal_footholds_world"][:, :, :2])
    reward_per_foot = -torch.log(0.8 + dis)
    return torch.sum(torch.where(ctx["contact_filt"], reward_per_foot, 0.0),
                     dim=-1)


REWARD_FUNCTIONS = {
    "lin_vel_z": reward_lin_vel_z,
    "ang_vel_xy": reward_ang_vel_xy,
    "torques": reward_torques,
    "dof_vel": reward_dof_vel,
    "dof_acc": reward_dof_acc,
    "action_rate": reward_action_rate,
    "collision": reward_collision,
    "dof_pos_limits": reward_dof_pos_limits,
    "dof_vel_limits": reward_dof_vel_limits,
    "torque_limits": reward_torque_limits,
    "tracking_lin_vel": reward_tracking_lin_vel,
    "tracking_ang_vel": reward_tracking_ang_vel,
    "feet_air_time": reward_feet_air_time,
    "stumble": reward_stumble,
    "stand_still": reward_stand_still,
    "feet_contact_forces": reward_feet_contact_forces,
    "power": reward_power,
    "smooth": reward_smooth,
    "foot_clearance": reward_foot_clearance,
    "feet_slip": reward_feet_slip,
    "hip_pos": reward_hip_pos,
    "powerchange": reward_powerchange,
    "pos_acc": reward_pos_acc,
    "foot_acc": reward_foot_acc,
    "orientation": reward_orientation,
    "orientation_roll": reward_orientation_roll,
    "big_pitch": reward_big_pitch,
    "feet_stumble": reward_feet_stumble,
    "base_height": reward_base_height,
    "foothold_miss": reward_foothold_miss,
    "soft_tracking_lin_vel": reward_soft_tracking_lin_vel,
    "soft_tracking_ang_vel": reward_soft_tracking_ang_vel,
    "tracking_optimal_footholds": reward_tracking_optimal_footholds,
}


def active_reward_names(scales) -> list:
    """Nonzero-scale terms, 'termination' excluded (it is added after the
    positive clip, legged_robot.py:285-291)."""
    return [f.name for f in dataclasses.fields(scales)
            if getattr(scales, f.name) != 0.0 and f.name != "termination"]


def compute_rewards(names, scales_dt, ctx, only_positive, termination_scale_dt):
    """Sum scale_i * term_i, positive clip, then the termination term
    (legged_robot.py:274-291).  Returns (total (N,), per_term dict)."""
    total = torch.zeros_like(ctx["root_z"])
    per_term = {}
    for name in names:
        rew = REWARD_FUNCTIONS[name](ctx) * scales_dt[name]
        per_term[name] = rew
        total = total + rew
    if only_positive:
        total = torch.clamp(total, min=0.0)
    if termination_scale_dt != 0.0:
        rew = reward_termination(ctx) * termination_scale_dt
        per_term["termination"] = rew
        total = total + rew
    return total, per_term
