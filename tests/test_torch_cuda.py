"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test here needs a GPU and skips without one (the
decision is made inside the fixture).  Run on a machine with a card:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
(--noconftest: tests/conftest.py sets up JAX, which a GPU host need not
have; this module does not use it).
Each kernel runs on the inputs of a real step of a small lite3_dtc env
and is held to its plain version with the budgets of chip_smoke.py; the
gather kernel (a copy) on seeded fields, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from deep_tracking_control_tpu_torch import cuda_build
from deep_tracking_control_tpu_torch.env import cuda_planner
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.ops import cuda_gather
from deep_tracking_control_tpu_torch.physics import cuda_substep
from deep_tracking_control_tpu_torch.tasks.registry import get_cfgs
from deep_tracking_control_tpu_torch.terrain import cuda_sampler

pytestmark = pytest.mark.cuda
N = 64


@pytest.fixture(scope="module")
def recorded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build()
    task, _ = get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=N),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    env = LeggedEnv(task, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    params, state = env.init(gen)
    calls = {}
    originals = (cuda_substep.decimation_step, cuda_sampler.sample_all,
                 cuda_planner.select_footholds)

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return wrapped
    cuda_substep.decimation_step = recorder("k1", originals[0])
    cuda_sampler.sample_all = recorder("k2", originals[1])
    cuda_planner.select_footholds = recorder("k3", originals[2])
    try:
        for _ in range(3):
            actions = 0.3 * torch.randn((N, 12), generator=gen, device="cuda")
            state, out = env.step(params, state, actions, gen)
    finally:
        (cuda_substep.decimation_step, cuda_sampler.sample_all,
         cuda_planner.select_footholds) = originals
    torch.cuda.synchronize()
    return calls, out


def test_env_steps_on_the_card(recorded):
    _, out = recorded
    for k in ("obs", "privileged_obs", "rew"):
        assert out[k].is_cuda and torch.isfinite(out[k]).all(), k


def test_decimation_kernel_matches_plain(recorded):
    args, kwargs = recorded[0]["k1"]
    kwargs = {k: v for k, v in kwargs.items() if k != "consts"}
    phys, anchors, info = cuda_substep.decimation_step(*args, **kwargs)
    pphys, panchors, pinfo = cuda_substep.decimation_step_plain(*args, **kwargs)
    torch.cuda.synchronize()
    for k in phys:
        torch.testing.assert_close(phys[k], pphys[k], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(anchors, panchors, atol=1e-4, rtol=1e-4)
    for k in ("foot_pos", "foot_vel", "thigh_pos", "body_pts", "torques"):
        torch.testing.assert_close(info[k], pinfo[k], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(info["contact_forces"], pinfo["contact_forces"],
                               atol=1e-2, rtol=1e-4)


def test_sampler_kernel_matches_plain(recorded):
    args, _ = recorded[0]["k2"]
    h, gx, gy = cuda_sampler.sample_all(*args)
    ph, pgx, pgy = cuda_sampler.sample_all_plain(*args)
    near = cuda_sampler.Q_MIN3 + cuda_sampler.Q_MAX10
    assert torch.equal(h[:, :near], ph[:, :near])
    torch.testing.assert_close(h[:, near:], ph[:, near:], atol=1e-5, rtol=0)
    torch.testing.assert_close(gx, pgx, atol=1e-4, rtol=0)
    torch.testing.assert_close(gy, pgy, atol=1e-4, rtol=0)


def test_planner_kernel_matches_plain(recorded):
    (scal, heights, stat, ny), _ = recorded[0]["k3"]
    got = cuda_planner.select_footholds(scal, heights, stat, ny)
    want = cuda_planner.plan_plain(scal, heights, stat, ny)
    differ = (got != want).any(dim=1)
    assert differ.float().mean().item() <= 0.02
    np.testing.assert_array_equal(got[~differ].cpu().numpy(),
                                  want[~differ].cpu().numpy())


def test_wrappers_reject_bad_input(recorded):
    args, _ = recorded[0]["k2"]
    src, starts, origin, qx, qy = args
    with pytest.raises(ValueError):
        cuda_sampler.sample_all(src, starts.long(), origin, qx, qy)
    with pytest.raises(ValueError):
        cuda_sampler.sample_all(src, starts, origin, qx[:, :-1], qy[:, :-1])


@pytest.mark.parametrize("G, prefix", [(16, None), (1, 50), (3, 7)])
def test_gather_kernel_matches_plain(G, prefix):
    """Every field in one launch, bit-exact: 16-byte chunks (G=16), 4-byte
    words and odd byte counts (a 3-wide bf16 field at G=1 or 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(G)
    R = 96
    flat = dict(
        priv=torch.randn((R, 1389), generator=gen, device="cuda").bfloat16(),
        obs=torch.randn((R, 53), generator=gen, device="cuda"),
        odd=torch.randn((R, 3), generator=gen, device="cuda").bfloat16(),
        val=torch.randn((R,), generator=gen, device="cuda"))
    perm = torch.randperm(R // G, generator=gen, device="cuda")[:prefix]
    perm = perm.contiguous()
    before = cuda_gather.permute_groups.launches
    got = cuda_gather.permute_groups(flat, perm, G)
    want = cuda_gather.permute_groups_plain(flat, perm, G)
    torch.cuda.synchronize()
    assert cuda_gather.permute_groups.launches == before + 1
    for k in flat:
        assert torch.equal(got[k], want[k]), k


def test_gather_wrapper_rejects_bad_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = {"a": torch.zeros((16, 4), device="cuda")}
    with pytest.raises(ValueError):                       # out of range
        cuda_gather.permute_groups(x, torch.tensor([0, 4], device="cuda"), 4)
    with pytest.raises(ValueError):                       # not contiguous
        cuda_gather.permute_groups({"a": x["a"].t()},
                                   torch.arange(2, device="cuda"), 2)
    with pytest.raises(ValueError):                       # perm on the CPU
        cuda_gather.permute_groups(x, torch.arange(2), 4)
