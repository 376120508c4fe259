"""The foothold planner (K3) of the torch port against the JAX package.

The plain version of the port's planner kernel must reproduce
env/pallas_planner.py `plan_footholds_fused` (interpret mode), and the
port's plain planner with its debug outputs env/planner.py.  Scores agree
to float noise; the mean/variance reductions sum in another order, so a
score within noise of the 0.1 gate can flip a selection: at most 2% of
the selections may differ, and only at near-ties of the objective
(tests/test_pallas_planner.py:73-85).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env import pallas_planner as jpplan
from deep_tracking_control_tpu.env import planner as jplan
from deep_tracking_control_tpu.tasks.registry import get_cfgs
from deep_tracking_control_tpu_torch.env import cuda_planner as tpplan
from deep_tracking_control_tpu_torch.env import planner as tplan


def _inputs(N, seed):
    cfg, _ = get_cfgs("lite3_dtc")
    rng = np.random.default_rng(seed)
    H = cfg.terrain.measured_x_dim * cfg.terrain.measured_y_dim
    gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                         np.asarray(cfg.terrain.measured_points_y),
                         indexing="ij")
    hp = np.stack([gx.reshape(-1), gy.reshape(-1), np.zeros(gx.size)],
                  axis=1).astype(np.float32)
    base_pos = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                               rng.uniform(0.3, 0.5, (N, 1))], 1)
    quat = rng.normal(size=(N, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    arrays = dict(
        base_pos=base_pos, base_quat=quat,
        base_lin_vel=rng.normal(0, 0.5, (N, 3)),
        commands=rng.normal(0, 0.5, (N, 4)),
        hips=base_pos[:, None, :] + rng.normal(0, 0.2, (N, 4, 3)),
        heights=(rng.normal(0, 0.05, (N, H))
                 + 0.3 * (rng.random((N, H)) < 0.02)
                 + 1.5 * (rng.random((N, H)) < 0.005)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return cfg, hp, arrays


def _run(fn, to, cfg, hp, a, **kw):
    args = [to(a[k]) for k in ("base_pos", "base_quat", "base_lin_vel",
                               "commands", "hips", "heights")]
    return fn(cfg, *args, hp, cfg.terrain.measured_points_x,
              cfg.terrain.measured_points_y, **kw)


def _raw_score(a, ny=21, spacing=0.05):
    """The terrain score before the 0.1 gate, in float64 (N, H)."""
    rel = a["heights"].astype(np.float64) - a["base_pos"][:, 2:3]
    g = np.clip(rel, -0.5, 0.5)
    N, H = g.shape
    gg = g.reshape(N, H // ny, ny)
    dx = np.gradient(gg, spacing, axis=1).reshape(N, H)
    dy = np.gradient(gg, spacing, axis=2).reshape(N, H)
    edge = np.clip(np.std(g, axis=1, keepdims=True), 0.0, 0.3)
    return 0.2 * edge + np.hypot(dx, dy) + 0.3 * np.abs(g - g.mean(1, keepdims=True))


def _check_selections(got, want, ref, a, N):
    """Selections equal, or the flip is legitimate: a near-tie of the
    reference objective, or a chosen point whose score sits on the 0.1
    gate (float noise decides its side).  At most 2% may differ."""
    obs_g, obs_w = got["foothold_obs"], want["foothold_obs"]
    opt_g, opt_w = got["optimal_footholds_world"], want["optimal_footholds_world"]
    hw = np.asarray(ref["heights_world"])                   # (N, H, 3)
    total = np.asarray(ref["foothold_score"])               # (N, H, 4)
    raw = _raw_score(a)
    mismatch = 0
    for n in range(N):
        for leg in range(4):
            same = (abs(obs_g[n, leg] - obs_w[n, leg]) < 1e-6
                    and abs(obs_g[n, 4 + leg] - obs_w[n, 4 + leg]) < 1e-6
                    and np.allclose(opt_g[n, leg], opt_w[n, leg], atol=1e-5))
            if same:
                continue
            mismatch += 1
            picks = [int(np.argmin(np.abs(hw[n, :, :2] - o[n, leg, :2]).sum(-1)))
                     for o in (opt_g, opt_w)]
            near_tie = total[n, picks[0], leg] <= total[n, :, leg].min() + 1e-4
            on_gate = any(abs(raw[n, k] - 0.1) < 1e-5 for k in picks)
            assert near_tie or on_gate, (n, leg, picks)
    assert mismatch <= N * 4 * 0.02, f"{mismatch} selection mismatches"


@pytest.mark.parametrize("seed,N", [(0, 24), (1, 5)])
def test_fused_plain_matches_pallas_kernel(seed, N):
    cfg, hp, a = _inputs(N, seed)
    want = _run(jpplan.plan_footholds_fused, jnp.asarray, cfg, hp, a,
                interpret=True)
    got = _run(tpplan.plan_footholds_fused, torch.from_numpy, cfg, hp, a)
    np.testing.assert_allclose(got["pred_footholds"].numpy(),
                               np.asarray(want["pred_footholds"]),
                               rtol=1e-6, atol=1e-6)
    ref = _run(jplan.plan_footholds, jnp.asarray, cfg, hp, a)
    _check_selections({k: v.numpy() for k, v in got.items()},
                      {k: np.asarray(v) for k, v in want.items()}, ref, a, N)


def test_plain_planner_matches_jax_planner():
    N = 24
    cfg, hp, a = _inputs(N, 2)
    want = _run(jplan.plan_footholds, jnp.asarray, cfg, hp, a)
    got = _run(tplan.plan_footholds, torch.from_numpy, cfg, hp, a)
    for k in ("pred_footholds", "heights_world"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    score_w = np.asarray(want["foothold_score"])
    score_g = got["foothold_score"].numpy()
    # scores agree except where a term sits on the 0.1 gate (then 10 vs <0.1)
    close = np.isclose(score_g, score_w, rtol=1e-5, atol=1e-5)
    assert close.mean() > 0.999
    _check_selections({k: v.numpy() for k, v in got.items()},
                      {k: np.asarray(v) for k, v in want.items()}, want, a, N)


def test_launch_shape():
    """A warp an env, 8 envs a block: 512 blocks at 4096 envs."""
    assert tpplan.launch_shape(4096) == (512, 256, 8)
    assert tpplan.launch_shape(37) == (5, 256, 8)
