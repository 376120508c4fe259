"""The reward stack of the env step: the CUDA kernel csrc/rewards.cu and
its plain version.

Replaces the JAX package's experimental/pallas_rewards.py
`compute_rewards_fused` (the Pallas kernel `_kernel`): every active term of
env/rewards.py times its scale * dt, the positive clip, the termination
term, the (K, N) episode sums and the three pieces of reward state
(feet_air_time, the stumble ring, the pitch filter).  On the TPU XLA fused
the terms and the Pallas kernel was an opt-in (DTC_PALLAS_REWARDS); on the
card they ran as some two hundred small PyTorch ops a step, so this
package has one path: the kernel on the card, the plain version
(rewards.compute_rewards plus the sum) on the CPU.

Both versions add to `episode_sums` in place (the widest per-step
accumulator) and return the updates of the stateful terms exactly when
those terms are active, as ctx["updates"] holds them.  The kernel reads
every input through its strides, so the env's transposed views of the
physics outputs go in without copies; it stages a block's per-env rows
in shared memory and runs a team of lanes an env (`TEAM` lanes, `ENVS`
envs a block: constants of the kernel).  The plane fit of the
orientation terms is a matrix product in the plain version, as in the
JAX package, and a reduction over the scan row inside the kernel: the
card path queues the kernel alone.
"""
from __future__ import annotations


import numpy as np
import torch

from . import rewards as rew_mod

TERM_IDS = {name: i for i, name in enumerate(rew_mod.REWARD_FUNCTIONS)}
MAX_TERMS = 40                    # csrc/rewards.cu
MAX_FEET = 8
MAX_WORDS = 320                   # staged words an env (csrc/rewards.cu)
MAX_CWORDS = 160                  # staged constants a block
TEAM = 16                         # lanes an env (csrc/rewards.cu)
ENVS = 16                         # envs a block (TEAM * ENVS threads)

# the kernel's inputs in the order of csrc/rewards.cu `In`: ctx key, dtype
_F32 = ["base_lin_vel", "base_ang_vel", "projected_gravity", "dof_pos",
        "dof_vel", "last_dof_vel", "actions", "last_actions",
        "last_actions_2", "torques", "contact_forces", "feet_air_time",
        "commands", "cmd_buffer", "lin_vel_buffer", "ang_vel_buffer",
        "default_dof_pos", "soft_lo", "soft_hi", "dof_vel_limit",
        "torque_limit", "robot_mass", "foot_positions", "foot_velocities",
        "last_foot_velocities", "measured_foot_clearance", "pitch_est",
        "acc_points", "optimal_footholds_world", "root_z", "env_origin_z",
        "lin_vel_x_max"]
_BOOL = ["feet_contact", "last_contacts", "contact_filt", "stumb_buffer",
         "reset_buf", "time_out_buf"]
_I32 = ["terrain_levels"]
_I64 = ["feet_idx", "penalised_idx", "hip_dof_idx"]
# the plane fit's inputs, last in csrc/rewards.cu `In`
_PLANE = ["measured_heights", "plane_pinv"]
# the term buffers' rows the terms read: the last 4 (csrc/rewards.cu)
BUFFER_ROWS = 4


def rewards_plain(names, scales_dt, ctx, only_positive, termination_scale_dt,
                  sum_names, episode_sums):
    """Plain PyTorch version of the kernel: rewards.compute_rewards, then
    the per-term values added to `episode_sums` in place."""
    ctx = dict(ctx, updates={})
    total, per_term = rew_mod.compute_rewards(names, scales_dt, ctx,
                                              only_positive,
                                              termination_scale_dt)
    episode_sums += torch.stack([per_term[n] for n in sum_names])
    return total, ctx["updates"]


def compute_rewards_fused(names, scales_dt, ctx, only_positive,
                          termination_scale_dt, sum_names, episode_sums):
    """Sum of scale_i * term_i over `names` (reference order), the positive
    clip, then the termination term; each term's value is added to its row
    of `episode_sums` (K, N), in place.  ctx: the step quantities of
    env/rewards.py (env-leading, any strides).  Returns (rew (N,),
    updates) with updates holding feet_air_time (N, nf), stumb_buffer
    (N, 5, nf) bool and pitch_est (N,) exactly when a term that owns them
    is active.  Tables without an env dim (the default joint angles, the
    limits) are staged once a block; a table with a leading dim of 1 has
    one at a single env and would be staged as that env's, so pass tables
    without it.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    dev = ctx["root_z"].device
    return rewards_plain(names, scales_dt, ctx, only_positive,
                         termination_scale_dt, sum_names, episode_sums)

# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
