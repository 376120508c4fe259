"""The observation tail of the env step: the CUDA kernel csrc/obs.cu and
its plain version.

Replaces the JAX package's experimental/pallas_obs.py
`compute_observations_fused` (the Pallas kernel `_kernel`), the fused form
of its env/legged_env.py `_compute_observations` (dtc.py:254-288 and
history_wrapper.py:17-24): the 53-dim DTC obs (45 without the foothold
block), its noise, the height-scan chain, the 1389-dim privileged obs with
its noise, both clips and the obs-history roll.  On the TPU XLA fused this
glue and the Pallas kernel was an opt-in (DTC_PALLAS_OBS); on the card it
ran as some twenty small PyTorch ops, so this package has one path: the
kernel on the card, the plain version on the CPU.

Both uniform draws come from Philox keyed by `seed` (ops/cuda_rng.py):
the height noise is stream 0 and the obs noise stream 1 of that counter
layout, drawn inside the kernel.  The plain version may instead be given
the two draws as arrays (tests feed it the JAX package's); the kernel
takes only the seed.  Outside the noise the two versions compute the same
float32 operations in the same order and agree exactly.  `row0` is the
global row of env 0: a rank that holds envs [row0, row0 + N) of a sharded
run draws those rows of the unsharded run's noise (the kernel needs row0
0 mod 4, the plain version takes any).

The kernel runs ENVS envs a block of THREADS threads (constants of
csrc/obs.cu, mirrored here by `launch_shape`): it stages the block's
height rows and history span with asynchronous copies, draws the height
noise while they arrive, and writes each output's span of rows as
16-byte stores.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from ..ops import cuda_rng

F32 = torch.float32
HEIGHT_STREAM, OBS_STREAM = 0, 1
ENVS = 16             # envs a block of the kernel (csrc/obs.cu)
THREADS = 512         # threads a block


def launch_shape(n: int) -> tuple:
    """(blocks, threads a block, envs a block) of the kernel at n envs."""
    return (n + ENVS - 1) // ENVS, THREADS, ENVS


def observations_plain(cfg, has_foothold, base_ang_vel, projected_gravity,
                       commands, q, qd, actions, foothold_obs, base_z,
                       measured_heights, push_force, height_noise_offset,
                       obs_history, noise_scale_vec, default_q, commands_scale,
                       seed, height_noise=None, obs_noise=None, row0=0):
    """Plain PyTorch version of the kernel; see compute_observations_fused.
    Draws not given are made from `seed` on its device, from global row
    `row0` on."""
    os_ = cfg.normalization.obs_scales
    parts = [
        base_ang_vel * os_.ang_vel,
        projected_gravity,
        commands[:, :3] * commands_scale,
        (q.T - default_q[None, :]) * os_.dof_pos,
        qd.T * os_.dof_vel,
        actions,
    ]
    if has_foothold:                      # 53-dim DTC layout (dtc.py:269)
        parts.append(foothold_obs)
    obs = torch.cat(parts, dim=1)

    heights = torch.clamp(
        base_z[:, None] - cfg.rewards.base_height_target - measured_heights,
        -1.0, 1.0) * os_.height_measurements                     # dtc.py:275
    if height_noise is None:
        height_noise = cuda_rng.uniform_pm1_plain(
            seed, heights.shape, HEIGHT_STREAM, row0 * heights.shape[1])
    noisy_heights = (heights + height_noise * 0.1
                     + height_noise_offset[:, None])
    privileged = torch.cat([noisy_heights, push_force * os_.force, heights],
                           dim=1)
    if cfg.noise.add_noise:                                      # dtc.py:284-287
        if obs_noise is None:
            obs_noise = cuda_rng.uniform_pm1_plain(
                seed, obs.shape, OBS_STREAM, row0 * obs.shape[1])
        obs = obs + obs_noise * noise_scale_vec[None, :]

    clip_obs = cfg.normalization.clip_observations
    obs = torch.clamp(obs, -clip_obs, clip_obs)                  # step :118-121
    privileged = torch.clamp(privileged, -clip_obs, clip_obs)
    # HistoryWrapper.step (history_wrapper.py:17-24): roll after the obs;
    # the reference never zeroes the history on resets
    num_obs = obs.shape[1]
    obs_history = torch.cat([obs_history[:, num_obs:], obs], dim=1)
    return obs, privileged, obs_history


def compute_observations_fused(cfg, has_foothold, base_ang_vel,
                               projected_gravity, commands, q, qd, actions,
                               foothold_obs, base_z, measured_heights,
                               push_force, height_noise_offset, obs_history,
                               noise_scale_vec, default_q, commands_scale,
                               seed, height_noise=None, obs_noise=None,
                               row0=0):
    """Observations, privileged observations and the rolled history.

    Env-leading float32 inputs: base_ang_vel, projected_gravity (N,3),
    commands (N,4), actions (N,na), foothold_obs (N,8), base_z (N,),
    measured_heights (N,H), push_force (N,3), height_noise_offset (N,),
    obs_history (N,hist); q and qd are (nq,N) as the physics state holds
    them; noise_scale_vec (num_obs,), default_q (nq,), commands_scale (3,);
    seed (2,) int64; row0 the global row of env 0 (module docstring).
    Any strides (the kernel reads views where they lie).
    Returns obs (N,num_obs), privileged (N,2H+3), obs_history (N,hist).

    CPU tensors take the plain version, which also takes the draws
    height_noise (N,H) and obs_noise (N,num_obs) as arrays; CUDA tensors
    launch the kernel, which draws them from `seed`, or raise."""
    args = (cfg, has_foothold, base_ang_vel, projected_gravity, commands, q,
            qd, actions, foothold_obs, base_z, measured_heights, push_force,
            height_noise_offset, obs_history, noise_scale_vec, default_q,
            commands_scale, seed)
    dev = base_ang_vel.device
    if dev.type == "cpu":
        return observations_plain(*args, height_noise=height_noise,
                                  obs_noise=obs_noise, row0=row0)
    if height_noise is not None or obs_noise is not None:
        raise ValueError("the kernel draws its noise from the seed; noise "
                         "arrays are taken on the CPU only")
    return _launch(*args, row0)


def _launch(cfg, has_foothold, base_ang_vel, projected_gravity, commands, q,
            qd, actions, foothold_obs, base_z, measured_heights, push_force,
            height_noise_offset, obs_history, noise_scale_vec, default_q,
            commands_scale, seed, row0):
    dev = base_ang_vel.device
    cuda_rng._check_seed(seed)
    if row0 < 0 or row0 % 4:
        raise ValueError(f"row0 {row0}: the kernel takes a multiple of 4")
    if seed.device != dev:
        raise ValueError(f"seed: on {seed.device}, expected {dev}")
    N, H = measured_heights.shape
    nq = q.shape[0]
    na = actions.shape[1]
    num_obs = noise_scale_vec.shape[0]
    hist_w = obs_history.shape[1]
    if num_obs != 9 + 2 * nq + na + (8 if has_foothold else 0):
        raise ValueError(f"num_obs {num_obs} does not match nq {nq}, "
                         f"na {na}, foothold block {has_foothold}")
    if hist_w < num_obs:
        raise ValueError(f"history width {hist_w} < num_obs {num_obs}")
    if commands.dim() != 2 or commands.shape[1] < 3:
        raise ValueError(f"commands: shape {tuple(commands.shape)}")

    def v(t, name, shape):
        return cuda_build.view(t, name, shape, F32, dev)
    views = [
        v(base_ang_vel, "base_ang_vel", (N, 3)),
        v(projected_gravity, "projected_gravity", (N, 3)),
        v(commands, "commands", (N, commands.shape[1])),
        v(q, "q", (nq, N)),
        v(qd, "qd", (nq, N)),
        v(actions, "actions", (N, na)),
        v(foothold_obs, "foothold_obs", (N, 8)),
        v(base_z, "base_z", (N,)),
        v(measured_heights, "measured_heights", (N, H)),
        v(push_force, "push_force", (N, 3)),
        v(height_noise_offset, "height_noise_offset", (N,)),
        v(obs_history, "obs_history", (N, hist_w)),
        v(noise_scale_vec, "noise_scale_vec", (num_obs,)),
        v(default_q, "default_q", (nq,)),
        v(commands_scale, "commands_scale", (3,)),
        [seed.data_ptr(), 1, 0, 0],
    ]
    obs = torch.empty((N, num_obs), dtype=F32, device=dev)
    priv = torch.empty((N, 2 * H + 3), dtype=F32, device=dev)
    hist = torch.empty((N, hist_w), dtype=F32, device=dev)
    os_ = cfg.normalization.obs_scales
    table = (ctypes.c_longlong * (3 * len(views) + 3))(
        *[x[0] for x in views], *[x[1] for x in views],
        *[x[2] for x in views], obs.data_ptr(), priv.data_ptr(),
        hist.data_ptr())
    fparams = (ctypes.c_float * 7)(
        os_.ang_vel, os_.dof_pos, os_.dof_vel, os_.force,
        os_.height_measurements, cfg.rewards.base_height_target,
        cfg.normalization.clip_observations)
    flags = (1 if has_foothold else 0) | (2 if cfg.noise.add_noise else 0)
    cuda_build.launch("dtc_observations", table, fparams, N, H, nq, na,
                      num_obs, hist_w, flags, row0, cuda_build.stream_ptr(dev))
    _counter.launches += 1
    return obs, priv, hist


# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
compute_observations_fused.launches = 0
_counter = compute_observations_fused
