"""Every reward term of the torch port against the JAX package.

One step context of random float32 values (made with numpy from a seed,
with contacts, stumbles and limit violations present) goes through each
term of env/rewards.py in both packages; terms and their state updates
agree to 1e-5 relative (the same operations; only libm differs in exp,
atan, log).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env import rewards as jrew
from deep_tracking_control_tpu.robot import quadrupeds
from deep_tracking_control_tpu_torch.env import rewards as trew

N = 6
TOL = dict(rtol=1e-5, atol=1e-6)


def _ctx():
    rng = np.random.default_rng(17)
    f32 = np.float32
    model = quadrupeds.get_robot("lite3")

    def a(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(f32)
    xs = np.round(np.arange(-0.8, 0.85, 0.05), 2)
    ys = np.round(np.arange(-0.5, 0.55, 0.05), 2)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    A = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], 1)
    cf = a(N, model.num_bodies, 3, scale=30.0)
    cf[:, :, :][rng.random((N, model.num_bodies)) < 0.4] = 0.0
    lo, hi = model.pos_limit[:, 0].astype(f32), model.pos_limit[:, 1].astype(f32)
    arrays = dict(
        base_lin_vel=a(N, 3), base_ang_vel=a(N, 3),
        projected_gravity=a(N, 3, scale=0.5), dof_pos=a(N, 12, scale=1.5),
        dof_vel=a(N, 12, scale=10.0), last_dof_vel=a(N, 12, scale=10.0),
        actions=a(N, 12), last_actions=a(N, 12), last_actions_2=a(N, 12),
        torques=a(N, 12, scale=20.0), contact_forces=cf,
        feet_contact=rng.random((N, 4)) < 0.5,
        last_contacts=rng.random((N, 4)) < 0.5,
        contact_filt=rng.random((N, 4)) < 0.5,
        feet_air_time=np.abs(a(N, 4, scale=0.3)) * (rng.random((N, 4)) < 0.7),
        stumb_buffer=rng.random((N, 5, 4)) < 0.1,
        commands=a(N, 4, scale=0.5), cmd_buffer=a(N, 10, 4, scale=0.5),
        lin_vel_buffer=a(N, 10, 2, scale=0.5),
        ang_vel_buffer=a(N, 10, 1, scale=0.5),
        lin_vel_x_max=np.array(0.75, f32),
        default_dof_pos=a(1, 12), dof_vel_limit=model.vel_limit.astype(f32),
        torque_limit=(0.8 * model.effort_limit).astype(f32),
        robot_mass=(12.0 + a(N)).astype(f32),
        foot_positions=a(N, 4, 3, scale=0.2),
        foot_velocities=a(N, 4, 3), last_foot_velocities=a(N, 4, 3),
        measured_foot_clearance=a(N, 4, scale=0.2),
        measured_heights=a(N, gx.size, scale=0.1),
        plane_pinv=(np.linalg.inv(A.T @ A) @ A.T).astype(f32),
        pitch_est=a(N, scale=0.2),
        terrain_levels=rng.integers(0, 10, N).astype(np.int32),
        acc_points=a(8, 3, scale=0.1),
        optimal_footholds_world=a(N, 4, 3, scale=0.2),
        root_z=(0.3 + a(N, scale=0.05)).astype(f32), env_origin_z=a(N, scale=0.1),
        reset_buf=rng.random(N) < 0.5, time_out_buf=rng.random(N) < 0.3)
    scalars = dict(dt=0.02, ang_vel_yaw_max=0.5, tracking_sigma=0.25,
                   soft_dof_vel_limit=0.9, soft_torque_limit=0.95,
                   max_contact_force=40.0, max_acc=100.0,
                   base_height_target=0.32)
    idx = dict(feet_idx=np.array([4, 8, 12, 16]),
               penalised_idx=np.array([0, 2, 3, 6, 7, 10, 11, 14, 15]),
               hip_dof_idx=np.array([0, 3, 6, 9]))
    jctx = {k: jnp.asarray(v) for k, v in arrays.items()}
    jctx.update(scalars, **idx, soft_dof_pos_limits=(jnp.asarray(lo), jnp.asarray(hi)),
                updates={})
    tctx = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    tctx.update(scalars, **{k: torch.from_numpy(v) for k, v in idx.items()},
                soft_dof_pos_limits=(torch.from_numpy(lo), torch.from_numpy(hi)),
                updates={})
    return jctx, tctx


@pytest.mark.parametrize("name", sorted(jrew.REWARD_FUNCTIONS))
def test_reward_term_matches(name):
    assert sorted(trew.REWARD_FUNCTIONS) == sorted(jrew.REWARD_FUNCTIONS)
    jctx, tctx = _ctx()
    want = jrew.REWARD_FUNCTIONS[name](jctx)
    got = trew.REWARD_FUNCTIONS[name](tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(tctx["updates"]) == sorted(jctx["updates"])
    for k, v in jctx["updates"].items():
        np.testing.assert_allclose(tctx["updates"][k].numpy().astype(np.float32),
                                   np.asarray(v).astype(np.float32), **TOL,
                                   err_msg=k)


def test_compute_rewards_matches():
    from deep_tracking_control_tpu.env.config import RewardScales
    scales = RewardScales(feet_stumble=-0.5, big_pitch=-1.0, stumble=-0.1)
    names = jrew.active_reward_names(scales)
    assert trew.active_reward_names(scales) == names
    scales_dt = {n: getattr(scales, n) * 0.02 for n in names}
    jctx, tctx = _ctx()
    for only_positive in (False, True):
        jt, jper = jrew.compute_rewards(names, scales_dt, jctx, only_positive,
                                        -0.1 * 0.02)
        tt, tper = trew.compute_rewards(names, scales_dt, tctx, only_positive,
                                        -0.1 * 0.02)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        for n in jper:
            np.testing.assert_allclose(tper[n].numpy(), np.asarray(jper[n]),
                                       **TOL, err_msg=n)
