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

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
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


def launch_shape(n: int) -> tuple:
    """(blocks, threads a block, envs a block) of the kernel at n envs:
    a team of TEAM lanes an env, ENVS envs a block."""
    return (n + ENVS - 1) // ENVS, TEAM * ENVS, ENVS


@functools.lru_cache(maxsize=16)
def _staging_plan(layout):
    """Where the kernel reads each input in shared memory (csrc/rewards.cu
    RewardArgs), from the inputs' layout: per input of _F32 + _BOOL + _I32
    + _I64, (own, s0, s1, s2, d1, d2), `own` for a table without an env
    dim.  A per-env input goes into each env's staged row word by word
    (its input << 24 | the element's offset past the env's first); an
    input with a zero env stride and the tables go once a block into the
    block's constants.  Returns ctypes arrays (offs, words, cwords) and
    the two word counts; the layout is the same every step, so the plan
    is made once."""
    offs, words, cwords = [], [], []
    for i, (own, s0, s1, s2, d1, d2) in enumerate(layout):
        inner = (s0, s1) if own else (s1, s2)
        elems = [i << 24 | (b * inner[0] + c * inner[1])
                 for b in range(d1) for c in range(d2)]
        if not own and s0 != 0:
            offs.append(len(words))
            words += elems
        else:
            offs.append(-1 - len(cwords))
            cwords += elems
    if (len(words) > MAX_WORDS or len(cwords) > MAX_CWORDS
            or max(e & 0xFFFFFF for e in words + cwords) == 0xFFFFFF):
        raise ValueError(f"{len(words)} staged words an env and {len(cwords)} "
                         f"a block (the kernel takes {MAX_WORDS} and "
                         f"{MAX_CWORDS}), or an input's strides too wide")
    return ((ctypes.c_int * len(offs))(*offs),
            (ctypes.c_uint * max(len(words), 1))(*words),
            (ctypes.c_uint * max(len(cwords), 1))(*cwords),
            len(words), len(cwords))


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
    if dev.type == "cpu":
        return rewards_plain(names, scales_dt, ctx, only_positive,
                             termination_scale_dt, sum_names, episode_sums)
    return _launch(names, scales_dt, ctx, only_positive, termination_scale_dt,
                   sum_names, episode_sums)


def _launch(names, scales_dt, ctx, only_positive, termination_scale_dt,
            sum_names, episode_sums):
    dev = ctx["root_z"].device
    N = ctx["root_z"].shape[0]
    nq = ctx["dof_pos"].shape[1]
    nf = ctx["feet_idx"].shape[0]
    B = ctx["contact_forces"].shape[1]
    L = [ctx[k].shape[1] for k in ("cmd_buffer", "lin_vel_buffer",
                                   "ang_vel_buffer")]
    names = list(names)
    if len(names) > MAX_TERMS or nf > MAX_FEET:
        raise ValueError(f"{len(names)} terms, {nf} feet: the kernel takes "
                         f"{MAX_TERMS} and {MAX_FEET}")
    unknown = [n for n in names if n not in TERM_IDS]
    if unknown:
        raise ValueError(f"no reward term {unknown}")
    term_on = termination_scale_dt != 0.0
    rows = {n: i for i, n in enumerate(sum_names)}
    stray = set(rows) - set(names) - ({"termination"} if term_on else set())
    if stray:
        raise ValueError(f"episode sums {sorted(stray)} have no active term")
    cuda_build.check(episode_sums, "episode_sums", (len(sum_names), N),
                     torch.float32, dev)
    if min(L) < 4:
        raise ValueError(f"buffers of {L} steps: the terms read the last 4")

    orient = "orientation" in names or "orientation_roll" in names
    lo, hi = ctx["soft_dof_pos_limits"]
    inputs = dict(ctx, soft_lo=lo, soft_hi=hi)
    for k in ("cmd_buffer", "lin_vel_buffer", "ang_vel_buffer"):
        inputs[k] = ctx[k][:, -BUFFER_ROWS:]          # a view: no copy
    shapes = dict(
        base_lin_vel=(N, 3), base_ang_vel=(N, 3), projected_gravity=(N, 3),
        contact_forces=(N, B, 3), feet_air_time=(N, nf), commands=(N, 4),
        cmd_buffer=(N, BUFFER_ROWS, 4), lin_vel_buffer=(N, BUFFER_ROWS, 2),
        ang_vel_buffer=(N, BUFFER_ROWS, 1), robot_mass=(N,),
        foot_positions=(N, nf, 3), foot_velocities=(N, nf, 3),
        last_foot_velocities=(N, nf, 3), measured_foot_clearance=(N, nf),
        pitch_est=(N,),
        acc_points=tuple(ctx["acc_points"].shape),
        optimal_footholds_world=(N, nf, 3), root_z=(N,), env_origin_z=(N,),
        lin_vel_x_max=(N,), feet_contact=(N, nf), last_contacts=(N, nf),
        contact_filt=(N, nf), stumb_buffer=(N, 5, nf), reset_buf=(N,),
        time_out_buf=(N,), terrain_levels=(N,), feet_idx=(nf,),
        penalised_idx=tuple(ctx["penalised_idx"].shape),
        hip_dof_idx=tuple(ctx["hip_dof_idx"].shape))
    if len(shapes["acc_points"]) != 2 or shapes["acc_points"][1] != 3:
        raise ValueError(f"acc_points: shape {shapes['acc_points']}")
    # the plane fit (rewards._plane_norm) reads the scan only for the
    # orientation terms
    H = ctx["measured_heights"].shape[1] if orient else 0
    shapes.update(measured_heights=(N, H), plane_pinv=(3, H))
    table, layout = [], []
    for keys, dtype in ((_F32, torch.float32), (_BOOL, torch.bool),
                        (_I32, torch.int32), (_I64, torch.int64),
                        (_PLANE, torch.float32)):
        for k in keys:
            shape = shapes.get(k, (N, nq))
            if k in _PLANE:
                # read where they lie, by the plane fit alone
                table += (cuda_build.view(inputs[k], k, shape, dtype, dev)
                          + [shape[1], 1] if orient else [0, 0, 0, 0, 1, 1])
                continue
            v = cuda_build.view(inputs[k], k, shape, dtype, dev)
            # the index tables and the acceleration points have no env dim
            own = dtype is torch.int64 or k == "acc_points"
            d1, d2 = (tuple(shape if own else shape[1:]) + (1, 1))[:2]
            table += v + [d1, d2]
            layout.append((own, *v[1:], d1, d2))
    offs, words, cwords, n_words, n_cwords = _staging_plan(tuple(layout))
    # the env's row: the staged inputs, its plane fit (3), its term values
    # (MAX_TERMS, the termination term's, the total); an odd count of
    # words, so that the teams of a warp read other banks
    off_plane, off_val = n_words, n_words + 3
    row_words = (off_val + MAX_TERMS + 2) | 1

    rew = torch.empty((N,), dtype=torch.float32, device=dev)
    updates = {}
    if "feet_air_time" in names:
        updates["feet_air_time"] = torch.empty((N, nf), dtype=torch.float32,
                                               device=dev)
    if "foot_clearance" in names:
        updates["stumb_buffer"] = torch.empty((N, 5, nf), dtype=torch.bool,
                                              device=dev)
    if orient:
        updates["pitch_est"] = torch.empty((N,), dtype=torch.float32,
                                           device=dev)
    outs = [rew, episode_sums] + [updates.get(k) for k in (
        "feet_air_time", "stumb_buffer", "pitch_est")]

    inv = cuda_build.inv
    fparams = (ctypes.c_float * 9)(
        ctx["dt"], inv(ctx["dt"]), inv(ctx["tracking_sigma"]),
        inv(ctx["ang_vel_yaw_max"]), ctx["soft_dof_vel_limit"],
        ctx["soft_torque_limit"], ctx["max_contact_force"], ctx["max_acc"],
        ctx["base_height_target"])
    iparams = (ctypes.c_int * 15)(
        N, nq, nf, shapes["penalised_idx"][0], shapes["hip_dof_idx"][0],
        shapes["acc_points"][0], len(names), int(term_on),
        rows.get("termination", -1), int(bool(only_positive)), H, row_words,
        off_plane, off_val, n_cwords)
    n = max(len(names), 1)
    ids = (ctypes.c_int * n)(*[TERM_IDS[k] for k in names])
    term_rows = (ctypes.c_int * n)(*[rows.get(k, -1) for k in names])
    scales = (ctypes.c_float * n)(*[scales_dt[k] for k in names])
    cuda_build.launch(
        "dtc_compute_rewards", (ctypes.c_longlong * len(table))(*table),
        (ctypes.c_longlong * len(outs))(
            *[0 if t is None else t.data_ptr() for t in outs]),
        fparams, iparams, offs, words, cwords, ids, term_rows,
        scales, float(np.float32(termination_scale_dt)),
        cuda_build.stream_ptr(dev))
    _counter.launches += 1
    return rew, updates


# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
compute_rewards_fused.launches = 0
_counter = compute_rewards_fused
