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


import torch

from ..ops import cuda_rng

F32 = torch.float32
HEIGHT_STREAM, OBS_STREAM = 0, 1
ENVS = 16             # envs a block of the kernel (csrc/obs.cu)
THREADS = 512         # threads a block


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
    return observations_plain(*args, height_noise=height_noise,
                              obs_noise=obs_noise, row0=row0)

# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
