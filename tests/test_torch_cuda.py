"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test here needs a GPU and skips without one (the
decision is made inside the fixture).  Run on a machine with a card:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
(--noconftest: tests/conftest.py sets up JAX, which a GPU host need not
have; this module does not use it).
Each kernel runs on the inputs of a real step of a small lite3_dtc env
and is held to its plain version with the budgets of chip_smoke.py; the
gather kernel (a copy) on seeded fields, bit for bit; the reward kernel
also on random inputs that switch on all 33 terms; the noise kernel bit
for bit, and the obs kernel against its plain version fed that kernel's
draws; the patch and window copies bit for bit, and the decimation
kernel's window variant bit for bit against its fused variant, and its
float64 build against the plain version in float64.  The
physics, sampler, planner, reward and obs kernels also run on ragged n
envs: a single env, a partial warp, a partial last block (the sampler
with queries on cell edges and outside the patch, the reward kernel on
all 33 terms with and without the plane fit and the positive clip, the
obs kernel in the 45-dim layout, without obs noise, and on inputs laid
out otherwise than the env's: a contiguous scan, a strided history); and
every kernel of the default route on a real step of the eval_stones
world at the evaluation widths 1 and 100 envs.  The other policies: one
collect of each (ActorCritic, GRU and LSTM ActorCriticRecurrent) launches
the default route's kernels once a step, and update_recurrent of a small
net on the card against the CPU (TF32 off), as chip_smoke.py phase 11.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (DEFAULT_ROUTE, POLICIES, check_planner,
                        expected_launches, launch_counts, plain_float64,
                        planner_near_ties, small_recurrent_update_check,
                        synthetic_ctx, with_policy, zero_launches)
from deep_tracking_control_tpu_torch import cuda_build
from deep_tracking_control_tpu_torch.env import (cuda_obs, cuda_planner,
                                                 cuda_rewards)
from deep_tracking_control_tpu_torch.env import rewards as rew_mod
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.ops import cuda_gather, cuda_patch, cuda_rng
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
                 cuda_planner.select_footholds,
                 cuda_rewards.compute_rewards_fused,
                 cuda_obs.compute_observations_fused)

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            # the reward kernel adds to its last argument in place
            calls[name] = ((*args[:-1], args[-1].clone()) if name == "k6"
                           else args, kwargs)
            return fn(*args, **kwargs)
        return wrapped
    cuda_substep.decimation_step = recorder("k1", originals[0])
    cuda_sampler.sample_all = recorder("k2", originals[1])
    cuda_planner.select_footholds = recorder("k3", originals[2])
    cuda_rewards.compute_rewards_fused = recorder("k6", originals[3])
    cuda_obs.compute_observations_fused = recorder("k7", originals[4])
    try:
        for _ in range(3):
            actions = 0.3 * torch.randn((N, 12), generator=gen, device="cuda")
            state, out = env.step(params, state, actions, gen)
    finally:
        (cuda_substep.decimation_step, cuda_sampler.sample_all,
         cuda_planner.select_footholds, cuda_rewards.compute_rewards_fused,
         cuda_obs.compute_observations_fused) = originals
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


def _sampler_queries(args, n):
    """The step's sampler arguments cut to the first n envs, with some
    queries exactly on cell edges (world coordinates origin + i * hs) and
    some outside the patch on every side."""
    src, starts, origin, qx, qy = args
    starts, origin = starts[:n].contiguous(), origin[:n].contiguous()
    qx, qy = qx[:n].clone(), qy[:n].clone()
    hs = src.horizontal_scale
    i = torch.arange(qx.shape[1], device=qx.device, dtype=torch.float32)
    edge = slice(0, None, 5)
    qx[:, edge] = origin[:, 0:1] + (i[edge] % 64) * hs
    qy[:, edge] = origin[:, 1:2] + (i[edge] % 128) * hs
    for k, (dx, dy) in enumerate(((-3.0, 0.5), (9.0, 0.5), (0.5, -3.0),
                                  (0.5, 17.0))):
        for cols in (slice(1 + k, 704, 37), slice(705 + k, 736, 11)):
            qx[:, cols] = origin[:, 0:1] + dx
            qy[:, cols] = origin[:, 1:2] + dy
    return src, starts, origin, qx, qy


@pytest.mark.parametrize("n", [1, 3, 37, 45])
def test_sampler_kernel_ragged_envs(recorded, n):
    """K2 on the first n envs, queries on cell edges and outside the
    patch: the nearest samples bit for bit the plain version's (the patch
    coordinates are made in the kernel with PyTorch's rounding), bilinear
    heights 1e-5, slopes 1e-4; one launch."""
    args = _sampler_queries(recorded[0]["k2"][0], n)
    before = cuda_sampler.sample_all.launches
    h, gx, gy = cuda_sampler.sample_all(*args)
    ph, pgx, pgy = cuda_sampler.sample_all_plain(*args)
    torch.cuda.synchronize()
    assert cuda_sampler.sample_all.launches == before + 1
    assert h.shape == (n, cuda_sampler.Q_TOT) and gx.shape == (n, 24)
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


def _first_envs(args, n):
    """The decimation kernel's positional arguments cut to the first n envs
    (every env-trailing array, and the starts)."""
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x[..., :n].contiguous()
    out = list(args)
    for i in range(5, 17):
        out[i] = cut(args[i])
    out[19] = args[19][:n].contiguous()
    return out


@pytest.mark.parametrize("n", [1, 3, 37, 45])
def test_decimation_kernel_ragged_envs(recorded, n):
    """K1 and K1w on the first n envs of the step (45: a partial warp in a
    partial last block): within K1's budget of the plain version, and K1w
    bit for bit K1."""
    args, kwargs = recorded[0]["k1"]
    args = _first_envs(args, n)
    blocks, starts = args[18], args[19]
    fused = cuda_substep.decimation_step(*args, consts=kwargs["consts"])
    window = cuda_patch.extract_windows(blocks, starts)
    win = cuda_substep.decimation_step(*args[:18], None, None,
                                       consts=kwargs["consts"], window=window)
    plain = cuda_substep.decimation_step_plain(*args)
    torch.cuda.synchronize()
    for (name, a), (_, w), (_, p) in zip(_leaves(fused), _leaves(win),
                                         _leaves(plain)):
        assert a.shape[-1] == n, name
        assert torch.equal(a, w), name
        # contact forces come from 12 kN/m springs: 1e-6 m is 1e-2 N
        atol = 1e-2 if name == "contact_forces" else 1e-4
        torch.testing.assert_close(a, p, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 5, 37])
def test_planner_kernel_ragged_envs(recorded, n):
    """K3 on the first n envs of the step (a partial last block of 8):
    differences only at near-ties, as chip_smoke.py allows (with so few
    envs one near-tie is more than 2% of them, so no share is capped)."""
    (scal, heights, stat, ny), _ = recorded[0]["k3"]
    scal, heights = scal[:n].contiguous(), heights[:n].contiguous()
    got = cuda_planner.select_footholds(scal, heights, stat, ny)
    want = cuda_planner.plan_plain(scal, heights, stat, ny)
    torch.cuda.synchronize()
    assert got.shape == (n, 20)
    differ = planner_near_ties(got, want, scal, heights, stat, ny)
    np.testing.assert_array_equal(got[~differ].cpu().numpy(),
                                  want[~differ].cpu().numpy())


def test_planner_kernel_far_footholds_and_excluded_points(recorded):
    """K3 where every other env's nominal footholds lie 5 m away (no scan
    point within 0.16: each leg takes the first argmin of the far total)
    and every third env has excluded points (|rel| > 1)."""
    (scal, heights, stat, ny), _ = recorded[0]["k3"]
    scal, heights = scal.clone(), heights.clone()
    scal[::2, 5:13] += 5.0
    heights[::3, ::7] += 3.0
    got = cuda_planner.select_footholds(scal, heights, stat, ny)
    want = cuda_planner.plan_plain(scal, heights, stat, ny)
    torch.cuda.synchronize()
    differ = check_planner(got, want, scal, heights, stat, ny)
    np.testing.assert_array_equal(got[~differ].cpu().numpy(),
                                  want[~differ].cpu().numpy())
    far = got[::2]
    assert (far[:, 8:12] == far[:, 8:9]).all()      # one pick for all legs


def _odd_starts(args):
    """13 of the step's starts (not a multiple of anything), the first
    clipped at the last table row in the last column block."""
    blocks, starts = args[18], args[19]
    s = starts[:13].clone()
    s[0] = torch.tensor([blocks.shape[2] - 81, blocks.shape[1] - 1])
    return blocks, s


def test_patch_and_window_copies_match_plain(recorded):
    blocks, starts = _odd_starts(recorded[0]["k1"][0])
    before = (cuda_patch.extract_patches.launches,
              cuda_patch.extract_windows.launches)
    got = cuda_patch.extract_patches(blocks, starts)
    win = cuda_patch.extract_windows(blocks, starts)
    torch.cuda.synchronize()
    assert got.shape == (3, 13, 64, 128) and win.shape == (13, 40, 128)
    assert torch.equal(got, cuda_patch.extract_patches_plain(blocks, starts))
    assert torch.equal(win, cuda_patch.extract_windows_plain(blocks, starts))
    assert (cuda_patch.extract_patches.launches,
            cuda_patch.extract_windows.launches) == (before[0] + 1,
                                                     before[1] + 1)
    with pytest.raises(ValueError):
        cuda_patch.extract_patches(blocks, starts.long())
    with pytest.raises(ValueError):
        cuda_patch.extract_windows(blocks[:, :, :, :64], starts)


def test_window_variant_matches_fused(recorded):
    """K1w on the window copy and on a view of the patch copy: bit for bit
    the fused kernel's result, and within K1's budget of its plain
    version."""
    args, kwargs = recorded[0]["k1"]
    blocks, starts = args[18], args[19]
    fused = cuda_substep.decimation_step(*args, **kwargs)
    before = cuda_substep.decimation_step.window_launches
    for window in (cuda_patch.extract_windows(blocks, starts),
                   cuda_patch.extract_patches(blocks, starts)[0][:, 16:56]):
        got = cuda_substep.decimation_step(*args[:18], None, None,
                                           consts=kwargs["consts"],
                                           window=window)
        plain = cuda_substep.decimation_step_plain(*args[:18], window=window)
        torch.cuda.synchronize()
        for (name, a), (_, b), (_, c) in zip(_leaves(got), _leaves(fused),
                                             _leaves(plain)):
            assert torch.equal(a, b), name
            # contact forces come from 12 kN/m springs: 1e-6 m is 1e-2 N
            atol = 1e-2 if name == "contact_forces" else 1e-4
            torch.testing.assert_close(a, c, atol=atol, rtol=1e-4)
    assert cuda_substep.decimation_step.window_launches == before + 2


def test_float64_build_matches_plain_float64(recorded):
    """The decimation kernel's source built in double, on the step's
    inputs taken to double (the terrain and constant tables float32):
    within K1's budget of the plain version in double, counted on its own
    counter; the window variant has no float64 build."""
    args, kwargs = recorded[0]["k1"]
    wide = [a.double() if i != 18 and isinstance(a, torch.Tensor)
            and a.dtype == torch.float32 else a for i, a in enumerate(args)]
    wide[6] = {k: v.double() for k, v in args[6].items()}
    kw = {k: v for k, v in kwargs.items() if k != "consts"}
    counts = (cuda_substep.decimation_step.launches,
              cuda_substep.decimation_step.f64_launches)
    got = cuda_substep.decimation_step(*wide, **kwargs)
    want = plain_float64(cuda_substep.decimation_step_plain, args, kw)
    torch.cuda.synchronize()
    assert (cuda_substep.decimation_step.launches,
            cuda_substep.decimation_step.f64_launches) == (counts[0],
                                                           counts[1] + 1)
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == torch.float64, name
        atol = 1e-2 if name == "contact_forces" else 1e-4
        torch.testing.assert_close(a, b, atol=atol, rtol=1e-4)
    with pytest.raises(ValueError):
        cuda_substep.decimation_step(
            *wide[:18], None, None, consts=kwargs["consts"],
            window=torch.zeros((N, 40, 128), device="cuda"))


def _leaves(step):
    phys, anchors, info = step
    return sorted({**phys, "anchors": anchors, **info}.items())


def test_wrappers_reject_bad_input(recorded):
    args, _ = recorded[0]["k2"]
    src, starts, origin, qx, qy = args
    with pytest.raises(ValueError):
        cuda_sampler.sample_all(src, starts.long(), origin, qx, qy)
    with pytest.raises(ValueError):
        cuda_sampler.sample_all(src, starts, origin, qx[:, :-1], qy[:, :-1])
    with pytest.raises(ValueError):                       # origin on the CPU
        cuda_sampler.sample_all(src, starts, origin.cpu(), qx, qy)
    # contiguous rows that are not 16-byte aligned (float4 loads)
    shifted = torch.empty(qx.numel() + 1, device=qx.device)[1:].view(qx.shape)
    shifted.copy_(qx)
    with pytest.raises(ValueError):
        cuda_sampler.sample_all(src, starts, origin, shifted, qy)


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


def _check_rewards(args):
    """K6 against its plain version from the same episode sums: rew and
    sums rtol 2e-5 / atol 1e-5, feet_air_time 1e-6 / 1e-7, pitch_est
    1e-5 / 1e-6, the stumble ring exact."""
    *head, sums = args
    s_k, s_p = sums.clone(), sums.clone()
    before = cuda_rewards.compute_rewards_fused.launches
    rew, upd = cuda_rewards.compute_rewards_fused(*head, s_k)
    prew, pupd = cuda_rewards.rewards_plain(*head, s_p)
    torch.cuda.synchronize()
    assert cuda_rewards.compute_rewards_fused.launches == before + 1
    torch.testing.assert_close(rew, prew, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(s_k, s_p, rtol=2e-5, atol=1e-5)
    assert set(upd) == set(pupd)
    budgets = dict(feet_air_time=(1e-6, 1e-7), pitch_est=(1e-5, 1e-6))
    for k, v in upd.items():
        if k == "stumb_buffer":
            assert v.dtype == torch.bool and torch.equal(v, pupd[k])
        else:
            torch.testing.assert_close(v, pupd[k], rtol=budgets[k][0],
                                       atol=budgets[k][1])
    return upd


def test_rewards_kernel_matches_plain(recorded):
    (args, _) = recorded[0]["k6"]
    upd = _check_rewards(args)
    assert set(upd) == {"feet_air_time", "stumb_buffer", "pitch_est"}


@pytest.mark.parametrize("only_positive, term", [(False, -0.5), (True, -1.0),
                                                 (False, 0.0)])
def test_rewards_kernel_all_terms(only_positive, term):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    names = list(rew_mod.REWARD_FUNCTIONS)
    ctx = synthetic_ctx(256, 3, "cuda")
    scales = {n: 0.01 * (i + 1) * (-1) ** i for i, n in enumerate(names)}
    sum_names = names + (["termination"] if term else [])
    sums = torch.randn((len(sum_names), 256), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(1))
    _check_rewards((names, scales, ctx, only_positive, term, sum_names, sums))


@pytest.mark.parametrize("plane", [True, False])
@pytest.mark.parametrize("only_positive", [False, True])
@pytest.mark.parametrize("n", [1, 3, 37, 45])
def test_rewards_kernel_ragged_envs(n, only_positive, plane):
    """K6 at n envs (a partial block of 16 envs, a partial team of warps)
    on all 33 terms, or on all but the orientation terms (no plane fit),
    with and without the positive clip: the budgets of chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    names = [k for k in rew_mod.REWARD_FUNCTIONS
             if plane or k not in ("orientation", "orientation_roll")]
    ctx = synthetic_ctx(n, 7 + n, "cuda")
    scales = {k: 0.01 * (i + 1) * (-1) ** i for i, k in enumerate(names)}
    sum_names = names + ["termination"]
    sums = torch.randn((len(sum_names), n), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(n))
    upd = _check_rewards((names, scales, ctx, only_positive, -0.5, sum_names,
                          sums))
    assert ("pitch_est" in upd) == plane


def test_obs_kernel_matches_plain_fed_its_draws(recorded):
    args, kwargs = recorded[0]["k7"]
    assert all(v is None for v in kwargs.values())      # no noise arrays
    seed = args[-1]
    N, H = args[10].shape
    before = cuda_obs.compute_observations_fused.launches
    got = cuda_obs.compute_observations_fused(*args)
    assert cuda_obs.compute_observations_fused.launches == before + 1
    num_obs = args[14].shape[0]
    draws = dict(height_noise=cuda_rng.uniform_pm1(seed, (N, H), 0),
                 obs_noise=cuda_rng.uniform_pm1(seed, (N, num_obs), 1))
    fed = cuda_obs.observations_plain(*args, **draws)
    own = cuda_obs.observations_plain(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, fed, own):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        assert torch.equal(b, c)
    with pytest.raises(ValueError):
        cuda_obs.compute_observations_fused(*args, **draws)


def _obs_case(args, n, layout):
    """K7's recorded arguments cut to the first n envs (the env's views of
    its state, strided where the env's are), in a layout: "env" as the
    env hands them in; "contiguous_heights" the scan as a contiguous
    (n, 693) tensor (rows not 16-byte aligned); "no_foothold" the 45-dim
    layout with a contiguous 225-wide history, "no_foothold_view" with
    the history a view of the first 225 of each 265-wide row; "quiet" no
    obs noise."""
    a = list(args)
    for i in (2, 3, 4, 7, 8, 9, 10, 11, 12, 13):
        a[i] = a[i][:n]
    a[5], a[6] = a[5][:, :n], a[6][:, :n]
    if layout == "contiguous_heights":
        a[10] = a[10].contiguous()
    elif layout.startswith("no_foothold"):
        a[1] = False
        a[14] = a[14][:45]
        a[13] = a[13][:, :225]
        if layout == "no_foothold":
            a[13] = a[13].contiguous()
    elif layout == "quiet":
        a[0] = dataclasses.replace(a[0], noise=dataclasses.replace(
            a[0].noise, add_noise=False))
    return a


@pytest.mark.parametrize("layout", ["env", "contiguous_heights",
                                    "no_foothold", "no_foothold_view",
                                    "quiet"])
@pytest.mark.parametrize("n", [1, 3, 37, 45, N])
def test_obs_kernel_ragged_envs_and_layouts(recorded, n, layout):
    """K7 on the first n envs of the step (1, 3, 37, 45: not multiples of
    its envs a block) in each layout, against its plain version fed the
    noise kernel's draws (1e-6)."""
    args = _obs_case(recorded[0]["k7"][0], n, layout)
    seed = args[-1]
    H, num_obs = args[10].shape[1], args[14].shape[0]
    before = cuda_obs.compute_observations_fused.launches
    got = cuda_obs.compute_observations_fused(*args)
    assert cuda_obs.compute_observations_fused.launches == before + 1
    draws = dict(height_noise=cuda_rng.uniform_pm1(seed, (n, H), 0),
                 obs_noise=cuda_rng.uniform_pm1(seed, (n, num_obs), 1))
    want = cuda_obs.observations_plain(*args, **draws)
    torch.cuda.synchronize()
    shapes = [(n, num_obs), (n, 2 * H + 3), (n, args[13].shape[1])]
    for a, b, shape in zip(got, want, shapes):
        assert tuple(a.shape) == shape
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape, stream", [((N, 693), 0), ((N, 53), 1),
                                           ((3, 5), 7)])
def test_uniform_kernel_bit_exact(shape, stream):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = cuda_rng.draw_seed(torch.Generator("cuda").manual_seed(4), "cuda")
    before = cuda_rng.uniform_pm1.launches
    got = cuda_rng.uniform_pm1(seed, shape, stream)
    want = cuda_rng.uniform_pm1_plain(seed, shape, stream)
    torch.cuda.synchronize()
    assert cuda_rng.uniform_pm1.launches == before + 1
    assert torch.equal(got, want)


def test_uniform_kernel_moments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator("cuda").manual_seed(5)
    u = cuda_rng.uniform_pm1(cuda_rng.draw_seed(g, "cuda"), (4096, 693))
    v = cuda_rng.uniform_pm1(cuda_rng.draw_seed(g, "cuda"), (4096, 693))
    assert abs(float(u.mean())) < 0.01 and abs(float(u.var()) - 1 / 3) < 0.01
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert not torch.equal(u, v)


def test_new_wrappers_reject_bad_input(recorded):
    seed = torch.tensor([1, 2], device="cuda")
    with pytest.raises(ValueError):                       # int32 seed
        cuda_rng.uniform_pm1(seed.int(), (4, 4))
    (head, _) = recorded[0]["k6"]
    names, scales, ctx, *rest = head
    bad = dict(ctx, stumb_buffer=ctx["stumb_buffer"].float())
    with pytest.raises(ValueError):                       # a float ring
        cuda_rewards.compute_rewards_fused(names, scales, bad, *rest[:-1],
                                           rest[-1].clone())
    bad = dict(ctx, dof_vel=ctx["dof_vel"][:, :6])
    with pytest.raises(ValueError):                       # wrong shape
        cuda_rewards.compute_rewards_fused(names, scales, bad, *rest[:-1],
                                           rest[-1].clone())
    bad = dict(ctx, dof_pos=ctx["dof_pos"].cpu())
    with pytest.raises(ValueError):                       # on the CPU
        cuda_rewards.compute_rewards_fused(names, scales, bad, *rest[:-1],
                                           rest[-1].clone())


# ---- the evaluation widths ---------------------------------------------
# The evaluation scripts step 1 env (play_single), 4 (teleop), 64
# (eval_stones), 100 (play: a ragged last block of every kernel) and 256
# (analyze_terminations); chip_smoke.py phase 10 runs each.  Here every
# kernel of the default route on a real step of the eval_stones world (2 m
# pits between the stones) at 1 and 100 envs.

@pytest.fixture(scope="module", params=[1, 100], ids=["n1", "n100"])
def eval_width(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_tracking_control_tpu_torch.scripts import eval_stones
    cuda_build.build()
    n = request.param
    task, train = eval_stones.configure(*get_cfgs("lite3_dtc"), num_envs=n)
    env = LeggedEnv(task, terrain_seed=train.runner.seed + 7, device="cuda")
    gen = torch.Generator("cuda").manual_seed(n)
    params, state = env.init(gen)
    slots = ((cuda_substep, "decimation_step", "k1"),
             (cuda_sampler, "sample_all", "k2"),
             (cuda_planner, "select_footholds", "k3"),
             (cuda_rewards, "compute_rewards_fused", "k6"),
             (cuda_obs, "compute_observations_fused", "k7"),
             (cuda_rng, "uniform_pm1", "k8"))
    originals = [getattr(mod, attr) for mod, attr, _ in slots]
    calls = {}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            # the reward kernel adds to its last argument in place
            calls[name] = ((*args[:-1], args[-1].clone()) if name == "k6"
                           else args, kwargs)
            return fn(*args, **kwargs)
        return wrapped
    for (mod, attr, name), fn in zip(slots, originals):
        setattr(mod, attr, recorder(name, fn))
    try:
        for _ in range(3):
            actions = 0.3 * torch.randn((n, 12), generator=gen, device="cuda")
            state, out = env.step(params, state, actions, gen)
    finally:
        for (mod, attr, _), fn in zip(slots, originals):
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    assert set(calls) == {"k1", "k2", "k3", "k6", "k7", "k8"}
    return n, calls


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k6", "k7", "k8"])
def test_default_route_kernels_at_eval_widths(eval_width, kernel):
    """Each kernel of the default route against its plain version on the
    step's inputs, with chip_smoke.py's budgets: K1 1e-4 + 1e-4 rel
    (contact forces 1e-2 N); K2's nearest samples exact, bilinear 1e-5,
    slopes 1e-4; K3 apart only at near-ties; K6 as _check_rewards; K7
    1e-6 against its plain version fed the noise kernel's draws; K8 bit
    for bit at the reset's shape."""
    n, calls = eval_width
    args, kwargs = calls[kernel]
    if kernel == "k1":
        kw = {k: v for k, v in kwargs.items() if k != "consts"}
        got = cuda_substep.decimation_step(*args, **kwargs)
        want = cuda_substep.decimation_step_plain(*args, **kw)
        torch.cuda.synchronize()
        for (name, a), (_, p) in zip(_leaves(got), _leaves(want)):
            assert a.shape[-1] == n, name
            atol = 1e-2 if name == "contact_forces" else 1e-4
            torch.testing.assert_close(a, p, atol=atol, rtol=1e-4)
    elif kernel == "k2":
        h, gx, gy = cuda_sampler.sample_all(*args)
        ph, pgx, pgy = cuda_sampler.sample_all_plain(*args)
        near = cuda_sampler.Q_MIN3 + cuda_sampler.Q_MAX10
        assert h.shape[0] == n and torch.equal(h[:, :near], ph[:, :near])
        torch.testing.assert_close(h[:, near:], ph[:, near:], atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(gx, pgx, atol=1e-4, rtol=0)
        torch.testing.assert_close(gy, pgy, atol=1e-4, rtol=0)
    elif kernel == "k3":
        scal, heights, stat, ny = args
        got = cuda_planner.select_footholds(scal, heights, stat, ny)
        want = cuda_planner.plan_plain(scal, heights, stat, ny)
        torch.cuda.synchronize()
        assert got.shape == (n, 20)
        differ = planner_near_ties(got, want, scal, heights, stat, ny)
        np.testing.assert_array_equal(got[~differ].cpu().numpy(),
                                      want[~differ].cpu().numpy())
    elif kernel == "k6":
        _check_rewards(args)
    elif kernel == "k7":
        assert all(v is None for v in kwargs.values())
        seed = args[-1]
        N, H = args[10].shape
        assert N == n
        got = cuda_obs.compute_observations_fused(*args)
        draws = dict(height_noise=cuda_rng.uniform_pm1(seed, (N, H), 0),
                     obs_noise=cuda_rng.uniform_pm1(
                         seed, (N, args[14].shape[0]), 1))
        fed = cuda_obs.observations_plain(*args, **draws)
        for a, b in zip(got, fed):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    else:
        seed, shape = args
        assert tuple(shape)[0] == n
        assert torch.equal(cuda_rng.uniform_pm1(seed, shape),
                           cuda_rng.uniform_pm1_plain(seed, shape))


# ---- the other policies -------------------------------------------------

@pytest.fixture(scope="module")
def policy_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build()
    task, train = get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=N),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    return LeggedEnv(task, device="cuda"), train


@pytest.mark.parametrize("label", sorted(POLICIES))
def test_policy_collect_launch_counts(policy_env, label):
    """One collect of each policy at the PolicyCfg widths: every kernel of
    the default route once a step, no gather (the update's), a finite
    batch; the recurrent one stores the dones and its start carries."""
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    env, train = policy_env
    runner = OnPolicyRunner(env, with_policy(train, label))
    zero_launches()
    batch, _ = runner.collect()
    torch.cuda.synchronize()
    T = train.runner.num_steps_per_env
    assert launch_counts() == expected_launches(DEFAULT_ROUTE, T)
    for k, v in batch.items():
        for x in (v if isinstance(v, tuple) else (v,)):
            assert x.is_cuda and torch.isfinite(x.float()).all(), k
    assert ("init_carry_a" in batch) == (label != "ActorCritic")


@pytest.fixture
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_recurrent_update_card_vs_cpu(tf32_off, rnn_type):
    """update_recurrent of a small net on the card against the CPU (same
    weights, batch and env draws): gradient cosine >= 0.999 per group,
    stats at rtol 1e-3 (chip_smoke.small_recurrent_update_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cos, rel = small_recurrent_update_check(rnn_type)
    assert cos >= 0.999 and rel <= 1e-3
