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


def _enum(src, name):
    """The names of enum `name` of a CUDA source, in order."""
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [t.strip() for t in body.split(",") if t.strip()]


def _constant(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def test_kernel_constants_are_the_wrapper_s():
    """The wrapper's copies of csrc/rewards.cu's constants (the launch
    shape, the buffer rows, the table sizes) are the kernel's."""
    src = SRC.read_text()
    for name in ("TEAM", "ENVS", "BUFFER_ROWS", "MAX_TERMS", "MAX_FEET",
                 "MAX_WORDS", "MAX_CWORDS"):
        assert _constant(src, name) == getattr(cuda_rewards, name), name
    assert re.search(r"constexpr int THREADS = TEAM \* ENVS;", src)


def test_launch_shape_covers_the_card():
    """16 lanes an env, 16 envs a block: at the published 4096 envs 256
    blocks of 256 threads, on every one of the H100's 132 SMs."""
    assert cuda_rewards.launch_shape(4096) == (256, 256, 16)
    assert cuda_rewards.launch_shape(37) == (3, 256, 16)
    assert cuda_rewards.launch_shape(1) == (1, 256, 16)


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
                                 + cuda_rewards._I32 + cuda_rewards._I64
                                 + cuda_rewards._PLANE)
    # the inputs that may be staged in shared memory (those before
    # FEET_IDX) are the float32, bool and int32 ones, with their offsets
    staged = cuda_rewards._F32 + cuda_rewards._BOOL + cuda_rewards._I32
    assert slots.index("FEET_IDX") == len(staged)
    assert slots.index("FC") == len(cuda_rewards._F32)
    assert slots.index("LEVELS") == len(cuda_rewards._F32 + cuda_rewards._BOOL)
    assert slots[-3:-1] == ["HSCAN", "PINV"]


def _storage_word(t, at):
    """Element `at` of tensor t's storage, counted from t's own first
    element (as the kernel adds an offset to the view's address)."""
    flat = torch.empty(0, dtype=t.dtype).set_(
        t.untyped_storage(), 0,
        (t.untyped_storage().nbytes() // t.element_size(),))
    return float(flat[t.storage_offset() + at])


@pytest.mark.parametrize("transposed", [False, True])
def test_kernel_staging_plan_reads_every_input(monkeypatch, transposed):
    """The wrapper's staging plans, read as csrc/rewards.cu reads them
    (each env's row word by word, the block's constants once), give back
    every input the terms read, on contiguous inputs and on the env's
    transposed views."""
    from deep_tracking_control_tpu_torch import cuda_build
    got = {}
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, *args: got.update(args=args))
    monkeypatch.setattr(cuda_build, "stream_ptr",
                        lambda dev: cuda_build.Ptr(0))
    n = 37
    ctx = synthetic_ctx(n, 3, "cpu")
    if transposed:          # env-trailing arrays, as the physics hands in
        for k in ("base_lin_vel", "dof_pos", "dof_vel", "torques",
                  "measured_foot_clearance"):
            ctx[k] = ctx[k].T.contiguous().T
        for k in ("contact_forces", "foot_positions", "foot_velocities"):
            ctx[k] = ctx[k].permute(1, 2, 0).contiguous().permute(2, 0, 1)
    names = list(trew.REWARD_FUNCTIONS)
    cuda_rewards._launch(names, {k: 0.1 for k in names}, ctx, False, -0.5,
                         names + ["termination"],
                         torch.zeros((len(names) + 1, n)))
    table, _, _, ip, offs, words, cwords, *_ = got["args"]
    iparam = _enum(SRC.read_text(), "IParam")
    assert len(ip) == iparam.index("N_I")
    S, C = ip[iparam.index("I_OFF_PLANE")], ip[iparam.index("I_NC")]
    lo, hi = ctx["soft_dof_pos_limits"]
    inputs = dict(ctx, soft_lo=lo, soft_hi=hi)
    for k in ("cmd_buffer", "lin_vel_buffer", "ang_vel_buffer"):
        inputs[k] = ctx[k][:, -cuda_rewards.BUFFER_ROWS:]
    keys = (cuda_rewards._F32 + cuda_rewards._BOOL + cuda_rewards._I32
            + cuda_rewards._I64)

    def word(entry, env):
        k = entry >> 24
        t = inputs[keys[k]]
        assert table[6 * k] == t.data_ptr()
        return _storage_word(t, env * table[6 * k + 1] + (entry & 0xFFFFFF))
    rows = torch.tensor([[word(w, e) for w in list(words)[:S]]
                         for e in range(n)], dtype=torch.float64)
    cst = torch.tensor([word(c, 0) for c in list(cwords)[:C]],
                       dtype=torch.float64)
    for i, k in enumerate(keys):
        t, o = inputs[k].double(), offs[i]
        size = table[6 * i + 4] * table[6 * i + 5]
        if o >= 0:
            np.testing.assert_array_equal(rows[:, o:o + size],
                                          t.reshape(n, -1), err_msg=k)
        else:               # a zero env stride, or a table: its values
            flat = t.reshape(-1)
            want = flat[:size] if flat.numel() >= size else flat.expand(size)
            np.testing.assert_array_equal(cst[-1 - o:-1 - o + size], want,
                                          err_msg=k)
    assert S <= cuda_rewards.MAX_WORDS and C <= cuda_rewards.MAX_CWORDS


def test_kernel_staging_plan_fits_the_env_inputs(monkeypatch):
    """The wrapper's staging plan of the env's own reward inputs fits the
    kernel's rows at the evaluation widths (lite3_dtc, x30_dtc and
    lite3_rough at one env, lite3_dtc at 100): at one env every input
    with a leading dim of 1 is staged per env, so a table handed in as
    (1, nq) would overflow the env's row (the env passes its tables
    without an env dim)."""
    import dataclasses
    from deep_tracking_control_tpu_torch import cuda_build
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.tasks.registry import get_cfgs
    got, launched = {}, {}
    real = cuda_rewards.compute_rewards_fused

    def recorder(*args):
        got["args"] = args
        return real(*args)
    monkeypatch.setattr(cuda_rewards, "compute_rewards_fused", recorder)
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, *args: launched.update(args=args))
    monkeypatch.setattr(cuda_build, "stream_ptr",
                        lambda dev: cuda_build.Ptr(0))
    iparam = _enum(SRC.read_text(), "IParam")
    for task, n in (("lite3_dtc", 1), ("lite3_dtc", 100), ("x30_dtc", 1),
                    ("lite3_rough", 1)):
        cfg, _ = get_cfgs(task)
        cfg = dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env, num_envs=n),
            control=dataclasses.replace(cfg.control, decimation=2),
            terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2,
                                        border_size=4.0))
        env = LeggedEnv(cfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        params, state = env.init(gen)
        env.step(params, state, torch.zeros((n, env.num_actions)), gen)
        names, scales, ctx, only_positive, term, sum_names, sums = got["args"]
        cuda_rewards._launch(names, scales, ctx, only_positive, term,
                             sum_names, sums.clone())
        ip = launched["args"][3]
        assert ip[iparam.index("I_OFF_PLANE")] <= cuda_rewards.MAX_WORDS, task
        assert ip[iparam.index("I_NC")] <= cuda_rewards.MAX_CWORDS, task
