"""The port's fused reward stack (env/cuda_rewards.py, the plain version of
the CUDA kernel csrc/rewards.cu) against the JAX package's fused reward
kernel (experimental/pallas_rewards.py) in interpret mode.

The three cases of tests/test_pallas_rewards.py on its inputs (`make_ctx`,
numpy from a seed) at 128 envs: all 33 terms, the positive clip over a
DTC-like subset, and no termination row; the budgets are that file's
(rew and sums rtol 2e-5 / atol 1e-5, feet_air_time 1e-6 / 1e-7,
pitch_est 1e-5 / 1e-6, the stumble ring exact).  One JAX run per case,
shared by the module.
"""
import pathlib
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env import rewards as jrew
from deep_tracking_control_tpu.experimental.pallas_rewards import (
    compute_rewards_fused as jax_fused)
from deep_tracking_control_tpu_torch.env import cuda_rewards
from deep_tracking_control_tpu_torch.env import rewards as trew
from chip_smoke import synthetic_ctx
from tests.test_pallas_rewards import make_ctx

N = 128
ALL_NAMES = [n for n in jrew.REWARD_FUNCTIONS if n != "termination"]
SUBSET = ["tracking_lin_vel", "tracking_ang_vel", "lin_vel_z", "collision",
          "feet_air_time", "torques", "tracking_optimal_footholds",
          "foothold_miss", "soft_tracking_lin_vel", "soft_tracking_ang_vel"]
CASES = {"all_terms": (ALL_NAMES, False, -0.5, 0),
         "positive_clip_and_subset": (SUBSET, True, -1.0, 3),
         "no_termination_row": (["torques", "dof_vel", "power"], False, 0.0, 5)}
SRC = (pathlib.Path(__file__).resolve().parents[1]
       / "deep_tracking_control_tpu_torch" / "csrc" / "rewards.cu")


def _torch_ctx(ctx):
    out = {}
    for k, v in ctx.items():
        if k == "updates":
            continue
        if isinstance(v, tuple):
            out[k] = tuple(torch.from_numpy(np.array(x)) for x in v)
        elif isinstance(v, (float, int)):
            out[k] = v
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _run(names, only_positive, term_scale, seed):
    ctx = make_ctx(N=N, seed=seed)
    scales_dt = {n: float(0.01 * (i + 1) * (-1) ** i)
                 for i, n in enumerate(names)}
    sum_names = list(names) + (["termination"] if term_scale else [])
    sums0 = np.random.default_rng(99).normal(
        size=(len(sum_names), N)).astype(np.float32)
    jrew_, jsums, jupd = jax_fused(names, scales_dt, ctx, only_positive,
                                   term_scale, sum_names, jnp.asarray(sums0),
                                   interpret=True)
    tsums = torch.from_numpy(sums0.copy())
    trew_, tupd = cuda_rewards.compute_rewards_fused(
        names, scales_dt, _torch_ctx(ctx), only_positive, term_scale,
        sum_names, tsums)
    return dict(jax=(np.asarray(jrew_), np.asarray(jsums),
                     {k: np.asarray(v) for k, v in jupd.items()}),
                port=(trew_.numpy(), tsums.numpy(),
                      {k: v.numpy() for k, v in tupd.items()}))


@pytest.fixture(scope="module")
def runs():
    return {name: _run(*case) for name, case in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_rewards_match_jax_kernel(runs, case):
    (jr, js, ju), (tr, ts, tu) = runs[case]["jax"], runs[case]["port"]
    np.testing.assert_allclose(tr, jr, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=2e-5, atol=1e-5)
    assert set(tu) == set(ju)
    if "feet_air_time" in ju:
        np.testing.assert_allclose(tu["feet_air_time"], ju["feet_air_time"],
                                   rtol=1e-6, atol=1e-7)
    if "stumb_buffer" in ju:
        np.testing.assert_array_equal(tu["stumb_buffer"], ju["stumb_buffer"])
    if "pitch_est" in ju:
        np.testing.assert_allclose(tu["pitch_est"], ju["pitch_est"],
                                   rtol=1e-5, atol=1e-6)


def test_updates_follow_the_active_terms(runs):
    assert set(runs["all_terms"]["port"][2]) == {"feet_air_time",
                                                 "stumb_buffer", "pitch_est"}
    assert set(runs["positive_clip_and_subset"]["port"][2]) == {
        "feet_air_time"}
    assert not runs["no_termination_row"]["port"][2]
    # the clip precedes the termination term: the total less the
    # termination row is never negative
    tr, ts, _ = runs["positive_clip_and_subset"]["port"]
    before = np.random.default_rng(99).normal(
        size=ts.shape).astype(np.float32)
    assert np.all(tr - (ts - before)[-1] >= -1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_ctx_is_make_ctx(seed):
    """The inputs chip_smoke.py and the card tests hold the kernel to on all
    33 terms are the JAX package's make_ctx inputs."""
    want = _torch_ctx(make_ctx(N=64, seed=seed))
    got = synthetic_ctx(64, seed, "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, tuple):
            for a, b in zip(g, v):
                np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        elif isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(
                g.numpy(), v.numpy().astype(g.numpy().dtype), err_msg=k)
        else:
            assert g == v, k


def test_kernel_term_table_matches_the_plain_terms():
    """csrc/rewards.cu numbers the terms in the order of REWARD_FUNCTIONS
    and reads one input slot per name of cuda_rewards' table."""
    src = SRC.read_text()
    terms = re.search(r"enum Term \{(.*?)\};", src, re.S).group(1)
    terms = [t.strip().lower() for t in terms.split(",") if t.strip()]
    assert terms[-1] == "n_terms"
    assert terms[:-1] == list(trew.REWARD_FUNCTIONS)
    assert cuda_rewards.TERM_IDS == {n: i for i, n in enumerate(terms[:-1])}
    slots = re.search(r"enum In \{(.*?)\};", src, re.S).group(1)
    slots = [t.split("//")[0].strip() for t in re.split(r",|\n", slots)]
    slots = [t for t in slots if t and not t.startswith("//")]
    assert slots[-1] == "N_IN"
    assert len(slots) - 1 == len(cuda_rewards._F32 + cuda_rewards._BOOL
                                 + cuda_rewards._I32 + cuda_rewards._I64)
