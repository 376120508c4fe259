"""Network parts of the torch port against the JAX package, each on its
own inputs: the masked median and its gradient, the normal log-prob and
GAE, and the converter at a three-legged robot's widths.

The budgets of tests/test_torch_networks.py (whose helpers this file
uses): float32 parts to 1e-5 (the median exact, its gradient 1e-6), the
bf16 MLP outputs within 2% of the output's max magnitude.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.agent import ppo as jppo
from deep_tracking_control_tpu.env.config import AlgorithmCfg
from deep_tracking_control_tpu.models import networks as jnet
from deep_tracking_control_tpu_torch.agent import ppo as tppo
from deep_tracking_control_tpu_torch.convert import params_from_flax
from deep_tracking_control_tpu_torch.models import networks as tnet
from tests.test_torch_networks import N, _close_bf16, _j, _t


@pytest.mark.parametrize("n,frac", [(24, 0.1), (25, 0.3), (16, 0.0)])
def test_masked_median_matches(n, frac):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    x[0, :2] = x[1, :2]                          # ties
    valid = rng.random((n, 4)) >= frac
    want = np.asarray(jnet.masked_median(jnp.asarray(x), jnp.asarray(valid)))
    got = tnet.masked_median(torch.from_numpy(x), torch.from_numpy(valid))
    assert float(got) == float(want)
    assert float(got) == float(torch.median(torch.from_numpy(x[valid])))


def test_normal_log_prob_and_gae_match():
    rng = np.random.default_rng(5)
    T = 6
    mean, x = rng.normal(0, 1, (2, N, 12)).astype(np.float32)
    std = rng.uniform(0.3, 1.5, (N, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tppo.normal_log_prob(*map(torch.from_numpy, (mean, std, x))).numpy(),
        np.asarray(jppo.normal_log_prob(*map(jnp.asarray, (mean, std, x)))),
        rtol=1e-5, atol=1e-5)
    rew = rng.normal(0, 1, (T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    values = rng.normal(0, 1, (T, N)).astype(np.float32)
    last = rng.normal(0, 1, N).astype(np.float32)
    alg = AlgorithmCfg()
    jr, ja = jppo.PPO(net=None, alg=alg).compute_gae(
        jnp.asarray(rew), jnp.asarray(dones), jnp.asarray(values),
        jnp.asarray(last))
    tr, ta = tppo.PPO(net=None, alg=alg).compute_gae(
        torch.from_numpy(rew), torch.from_numpy(dones),
        torch.from_numpy(values), torch.from_numpy(last))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ties", [3, 1])
def test_masked_median_gradient_matches_jax(ties):
    """jax.grad of masked_median splits the cotangent equally among the
    valid elements equal to the median (the gradient of a max); without
    ties the one median element gets 1.0."""
    rng = np.random.default_rng(ties)
    x = rng.normal(0, 1, (6, 4)).astype(np.float32)
    valid = np.ones((6, 4), bool)
    valid[0, :3] = False
    med = float(np.sort(x[valid])[(valid.sum() + 1) // 2 - 1])
    flat = x.reshape(-1)
    others = [i for i in range(flat.size) if valid.reshape(-1)[i]
              and flat[i] != med]
    flat[others[:ties - 1]] = med                 # ties of the median
    flat[0] = med                                 # equal, but not valid
    want = np.asarray(jax.grad(lambda a: jnet.masked_median(
        a, jnp.asarray(valid)))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    tnet.masked_median(xt, torch.from_numpy(valid)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=0)
    assert np.isclose(want.sum(), 1.0)
    assert np.count_nonzero(want) == ties and want.reshape(-1)[0] == 0.0


def test_params_from_flax_three_leg_widths():
    """The converter at the widths of a robot that is not a 4x3 quadruped
    (chip_smoke.three_leg_task: 9 joints, 36-dim obs, 9 actions, 5 x 36
    history): every weight carried, and the teacher actor and the critic
    agree at the bf16 budget."""
    rng = np.random.default_rng(1)
    f32 = np.float32
    x = dict(obs=rng.normal(0, 1, (N, 36)).astype(f32),
             hist=rng.normal(0, 1, (N, 180)).astype(f32),
             priv=rng.normal(0, 1, (N, 1389)).astype(f32),
             base_vel=rng.normal(0, 1, (N, 3)).astype(f32))
    widths = dict(num_obs=36, num_actions=9, obs_history_dim=180)
    jm = jnet.ActorCriticDecoder(**widths)
    key = jax.random.PRNGKey(5)
    params = jax.jit(jm.init)(key, *(jnp.asarray(x[k]) for k in
                                     ("obs", "hist", "priv", "base_vel")), key)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "Dense_0" not in jax.tree_util.keystr(p)
        and "kernel" in jax.tree_util.keystr(p) else v, params)
    tm = tnet.ActorCriticDecoder(**widths)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                       strict=True)
    assert (sum(np.asarray(v).size for v in jax.tree.leaves(params))
            == sum(p.numel() for p in tm.parameters()))
    want = jm.apply(params, _j(x, "obs"), _j(x, "hist"), _j(x, "priv"),
                    method=jm.act_teacher)
    value = jm.apply(params, _j(x, "obs"), _j(x, "priv"), _j(x, "base_vel"),
                     method=jm.evaluate)
    with torch.no_grad():
        got = tm.act_teacher(_t(x, "obs"), _t(x, "hist"), _t(x, "priv"))
        tvalue = tm.evaluate(_t(x, "obs"), _t(x, "priv"), _t(x, "base_vel"))
    assert got.shape == (N, 9)
    _close_bf16(got, want, "act_teacher")
    _close_bf16(tvalue, value, "value")
