"""Networks and PPO acting of the torch port against the JAX package.

Weights come from the flax ActorCriticDecoder through params_from_flax;
the same numpy inputs (and the same standard normal latent draws) go
through both.  The MLPs compute in bfloat16 in both packages, rounding at
the same points; the order of the sums inside a matmul differs, so the
outputs agree to bf16 precision: max |diff| <= 2% of the output's max
magnitude (bf16 keeps 8 significant bits, 0.4% a rounding, over up to
four layers).  Float32 parts agree to 1e-5.  The parts that need no
shared net (the masked median and its gradient, normal_log_prob and GAE,
the converter at three-legged widths) are in
tests/test_torch_networks_parts.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.models import networks as jnet
from deep_tracking_control_tpu_torch.convert import params_from_flax
from deep_tracking_control_tpu_torch.models import networks as tnet

N = 8
BF16_REL = 0.02


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = dict(obs=rng.normal(0, 1, (N, 53)).astype(f32),
             hist=rng.normal(0, 1, (N, 265)).astype(f32),
             priv=rng.normal(0, 1, (N, 1389)).astype(f32),
             base_vel=rng.normal(0, 1, (N, 3)).astype(f32))
    jm = jnet.ActorCriticDecoder()
    key = jax.random.PRNGKey(3)
    params = jax.jit(jm.init)(key, *(jnp.asarray(x[k]) for k in
                                     ("obs", "hist", "priv", "base_vel")), key)
    # weights of a trained-looking scale: the orthogonal(0.01) init makes
    # every output tiny, so rescale the later layers to unit-gain
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "Dense_0" not in jax.tree_util.keystr(p)
        and "kernel" in jax.tree_util.keystr(p) else v, params)
    tm = tnet.ActorCriticDecoder()
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm, x


def _close_bf16(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= BF16_REL * scale + 1e-6, f"{name}: {err} vs max {scale}"


def _j(x, k):
    return jnp.asarray(x[k])


def _t(x, k):
    return torch.from_numpy(np.array(x[k]))


def test_params_from_flax_covers_every_weight(nets):
    jm, params, tm, x = nets
    n_flax = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    n_torch = sum(p.numel() for p in tm.parameters())
    assert n_flax == n_torch


def test_act_stats_matches(nets):
    jm, params, tm, x = nets
    key = jax.random.PRNGKey(11)
    eps = np.asarray(jax.random.normal(key, (N, 16), jnp.float32))
    jmean, jstd, (jmu, jlv, jz), _ = jm.apply(
        params, _j(x, "obs"), _j(x, "hist"), _j(x, "priv"), key,
        method=jm.act_stats)
    with torch.no_grad():
        tmean, tstd, (tmu, tlv, tz), _ = tm.act_stats(
            _t(x, "obs"), _t(x, "hist"), _t(x, "priv"), torch.from_numpy(np.array(eps)))
    _close_bf16(tmu, jmu, "mu")
    _close_bf16(tlv, jlv, "logvar")
    _close_bf16(tz, jz, "z")
    _close_bf16(tmean, jmean, "mean")
    np.testing.assert_array_equal(tstd.detach().numpy(), np.asarray(jstd))


@pytest.mark.parametrize("method", ["act_teacher", "act_deterministic"])
def test_deterministic_actors_match(nets, method):
    jm, params, tm, x = nets
    want = jm.apply(params, _j(x, "obs"), _j(x, "hist"), _j(x, "priv"),
                    method=getattr(jm, method))
    with torch.no_grad():
        got = getattr(tm, method)(_t(x, "obs"), _t(x, "hist"), _t(x, "priv"))
    _close_bf16(got, want, method)


def test_critic_matches(nets):
    jm, params, tm, x = nets
    want = jm.apply(params, _j(x, "obs"), _j(x, "priv"), _j(x, "base_vel"),
                    method=jm.evaluate)
    with torch.no_grad():
        got = tm.evaluate(_t(x, "obs"), _t(x, "priv"), _t(x, "base_vel"))
    _close_bf16(got, want, "value")


# ---- the training heads (the update slice) --------------------------------
# The losses are means over many bf16 MLP outputs in float32, so the
# reordered bf16 sums of the two frameworks average out: they agree to
# rtol 1e-5 (measured: at most 2.3e-7 here).

def _eps(seed):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (N, 16),
                                        jnp.float32))


@pytest.fixture(scope="module")
def heads_inputs(nets):
    rng = np.random.default_rng(7)
    return dict(next_obs=rng.normal(0, 1, (N, 53)).astype(np.float32))


def test_vae_losses_match(nets, heads_inputs):
    jm, params, tm, x = nets
    x = {**x, **heads_inputs}
    key = jax.random.PRNGKey(21)
    want = jm.apply(params, _j(x, "hist"), _j(x, "priv"), _j(x, "next_obs"),
                    _j(x, "base_vel"), key, method=jm.vae_losses)
    with torch.no_grad():
        got = tm.vae_losses(_t(x, "hist"), _t(x, "priv"), _t(x, "next_obs"),
                            _t(x, "base_vel"),
                            torch.from_numpy(np.array(jax.random.normal(
                                key, (N, 16), jnp.float32))))
    for name, g, w in zip(("recons", "vel", "kld", "height"), got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, err_msg=name)


def test_belief_loss_matches_and_trains_memory_only(nets):
    jm, params, tm, x = nets
    want = jm.apply(params, _j(x, "hist"), _j(x, "priv"),
                    method=jm.belief_loss)
    got = tm.belief_loss(_t(x, "hist"), _t(x, "priv"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    tm.zero_grad()
    got.backward()
    moved = {n.split(".")[1] for n, p in tm.named_parameters()
             if p.grad is not None and p.grad.abs().sum() > 0}
    tm.zero_grad()
    assert moved == {"memory_mlp"}        # l_t is detached: input and target


def test_joint_forward_matches(nets, heads_inputs):
    jm, params, tm, x = nets
    x = {**x, **heads_inputs}
    kv, kp = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    (wparts, wmean, wstd, wvalue) = jm.apply(
        params, _j(x, "obs"), _j(x, "hist"), _j(x, "priv"), _j(x, "next_obs"),
        _j(x, "base_vel"), kv, kp, method=jm.joint_forward)
    ev = np.asarray(jax.random.normal(kv, (N, 16), jnp.float32))
    ep = np.asarray(jax.random.normal(kp, (N, 16), jnp.float32))
    with torch.no_grad():
        gparts, gmean, gstd, gvalue = tm.joint_forward(
            _t(x, "obs"), _t(x, "hist"), _t(x, "priv"), _t(x, "next_obs"),
            _t(x, "base_vel"), torch.from_numpy(ev), torch.from_numpy(ep))
    for g, w in zip(gparts, wparts):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    _close_bf16(gmean, wmean, "mean")
    _close_bf16(gvalue, wvalue, "value")
    np.testing.assert_array_equal(gstd.detach().numpy(), np.asarray(wstd))


def test_mean_outlier_filter_matches(nets):
    """outlier_filter="mean": the >2-sigma entries of logvar take the mean
    of the others; the case has outliers."""
    _, params, _, x = nets
    jm = jnet.ActorCriticDecoder(outlier_filter="mean")
    tm = tnet.ActorCriticDecoder(outlier_filter="mean")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    wmu, wlv = jm.apply(params, _j(x, "hist"),
                        method=lambda m, h: m.vae.cenet_stats(h))
    with torch.no_grad():
        gmu, glv = tm.vae.cenet_stats(_t(x, "hist"))
        raw = tm.vae.latent_var(tm.vae.cenet_encoder(_t(x, "hist")))
    replaced = (glv != raw).numpy()
    assert replaced.any()
    _close_bf16(gmu, wmu, "mu")
    _close_bf16(glv, wlv, "logvar")
    # the replaced entries all hold one value, the mean of the others
    np.testing.assert_allclose(glv.numpy()[replaced],
                               raw.numpy()[~replaced].mean(), rtol=1e-5)
