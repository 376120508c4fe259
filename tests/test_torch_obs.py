"""The port's observation tail (env/cuda_obs.py, the plain version of the
CUDA kernel csrc/obs.cu) against the JAX package's fused obs kernel
(experimental/pallas_obs.py) in interpret mode.

Interpret mode draws zero bits, which the kernel maps to the constant
-1.0, so the port is fed noise arrays of -1.0: every assembly op (concats,
scales, the height chain, both noise adds, both clips, the history roll)
is then pinned at 1e-6.  The inputs are tests/test_pallas_obs.py's
(`_fake_inputs`, numpy from a seed) at 128 envs; the cases are the 53-dim
DTC layout with the obs noise on and off, the 45-dim layout, and the
53-dim layout of x30_rough with its foothold block zero (no planner).  One
JAX run per case, shared by the module.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.experimental import pallas_obs
from deep_tracking_control_tpu_torch.env import cuda_obs
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.ops import cuda_rng
from deep_tracking_control_tpu_torch.tasks.registry import get_cfgs
from tests.test_pallas_obs import _env, _fake_inputs

N = 128
SRC = (Path(__file__).resolve().parent.parent / "deep_tracking_control_tpu_torch"
       / "csrc" / "obs.cu")
CASES = {"dtc_53_noise": ("lite3_dtc", True, 0),
         "dtc_53_quiet": ("lite3_dtc", False, 2),
         "rough_45": ("lite3_rough", True, 1),
         "x30_rough_53_zero_foothold": ("x30_rough", True, 3)}


def _port_env(task, add_noise):
    """A port env of `task` for its obs constants."""
    cfg, _ = get_cfgs(task)
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, num_envs=N),
        terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2,
                                    border_size=4.0, max_init_terrain_level=1),
        noise=dataclasses.replace(cfg.noise, add_noise=add_noise))
    return LeggedEnv(cfg, device="cpu")


def _run(task, add_noise, seed):
    jenv = _env(task=task, num_envs=N, add_noise=add_noise)
    state, bav, pg, bp3, mh = _fake_inputs(jenv, seed=seed)
    if not jenv.cfg.use_dtc_planner:
        # without the planner the env hands the kernel a zero foothold
        # block (53-dim x30_rough keeps it in its layout)
        state = {**state,
                 "foothold_obs": jnp.zeros_like(state["foothold_obs"])}
    base_pos = jnp.concatenate([bp3[:, :2], 0.3 + 0.1 * bp3[:, 2:3]], axis=1)
    want = pallas_obs.compute_observations_fused(
        jenv, state, base_pos, bav, pg, mh, jax.random.PRNGKey(3),
        interpret=True)

    tenv = _port_env(task, add_noise)
    t = lambda x: torch.from_numpy(np.array(x))
    H = mh.shape[1]
    got = cuda_obs.compute_observations_fused(
        tenv.cfg, tenv._obs_has_foothold, t(bav), t(pg), t(state["commands"]),
        t(state["phys"]["q"]), t(state["phys"]["qd"]), t(state["actions"]),
        t(state["foothold_obs"]), t(base_pos[:, 2]), t(mh),
        t(state["push_force"]), t(state["height_noise_offset"]),
        t(state["obs_history"]), t(tenv.noise_scale_vec),
        t(tenv.default_dof_pos), t(tenv.commands_scale),
        torch.tensor([0, 0]), height_noise=torch.full((N, H), -1.0),
        obs_noise=torch.full((N, tenv.num_obs), -1.0))
    consts = [(tenv.noise_scale_vec, jenv.noise_scale_vec),
              (tenv.default_dof_pos, jenv.default_dof_pos),
              (tenv.commands_scale, jenv.commands_scale)]
    return ([np.asarray(x) for x in want], [x.numpy() for x in got], consts)


@pytest.fixture(scope="module")
def runs():
    return {name: _run(*case) for name, case in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_obs_tail_matches_jax_kernel(runs, case):
    want, got, consts = runs[case]
    for a, b in consts:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    num_obs = 45 if case.startswith("rough_45") else 53
    assert got[0].shape == (N, num_obs) and got[1].shape == (N, 1389)
    assert got[2].shape == (N, 5 * num_obs)
    for name, g, w in zip(("obs", "privileged", "history"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)


def test_plain_draws_are_the_noise_kernels():
    """Without noise arrays the plain version draws stream 0 (heights) and
    stream 1 (obs) of the seed, as the kernel does, bit for bit."""
    tenv = _port_env("lite3_dtc", True)
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    seed = cuda_rng.draw_seed(g, "cpu")
    args = (tenv.cfg, True, r(N, 3), r(N, 3), r(N, 4), r(12, N), r(12, N),
            r(N, 12), r(N, 8), 0.3 + 0.1 * r(N), 0.5 * r(N, 693), r(N, 3),
            0.02 * r(N), r(N, 265), torch.from_numpy(tenv.noise_scale_vec),
            torch.from_numpy(tenv.default_dof_pos),
            torch.from_numpy(tenv.commands_scale), seed)
    own = cuda_obs.compute_observations_fused(*args)
    fed = cuda_obs.compute_observations_fused(
        *args, height_noise=cuda_rng.uniform_pm1(seed, (N, 693), 0),
        obs_noise=cuda_rng.uniform_pm1(seed, (N, 53), 1))
    for a, b in zip(own, fed):
        assert torch.equal(a, b)
    quiet = cuda_obs.compute_observations_fused(
        *args, height_noise=torch.zeros((N, 693)),
        obs_noise=torch.zeros((N, 53)))
    assert not torch.equal(own[0], quiet[0])
    assert not torch.equal(own[1], quiet[1])


def test_launch_shape_is_the_kernel_s():
    """The wrapper's copy of csrc/obs.cu's launch shape (envs and threads
    a block, compile-time constants) is the kernel's: at the published
    4096 envs 256 blocks of 512 threads, 16 envs each, two blocks on each
    of the H100's 132 SMs; a ragged tail takes one more block."""
    src = SRC.read_text()

    def constant(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1))
    assert constant("ENVS") == cuda_obs.ENVS
    assert constant("THREADS") == cuda_obs.THREADS
    assert cuda_obs.ENVS % 4 == 0          # a block's spans start aligned
    assert re.search(r"__launch_bounds__\(THREADS\) obs_kernel", src)
    assert cuda_obs.launch_shape(4096) == (256, 512, 16)
    assert cuda_obs.launch_shape(37) == (3, 512, 16)
    assert cuda_obs.launch_shape(1) == (1, 512, 16)
