"""The PPO+VAE update of the torch port against the JAX package.

A tiny ActorCriticDecoder (terrain_latent 32, hidden (32,), as in
tests/test_ppo.py:65-90) with trained-scale weights, and a numpy-seeded
(T=8, N=8) batch with bf16 privileged obs and obs history (the rollout
storage of the main path).  The JAX update runs jitted on its XLA path;
its random draws are reproduced here from its key exactly as agent/ppo.py
makes them and handed to the port: k_perm, k_upd = split(key); the group
permutation(s) from k_perm; per minibatch step i, k_vae, k_pol =
split(split(k_upd, steps)[i]) and eps = normal(k, (minibatch rows, 16)).

Tolerances, and why:
  - the optimizer on identical float32 gradients: atol 1e-7 / rtol 1e-6
    (same arithmetic; only the order of the norm's sum differs);
  - the stats of one update from fresh states: rtol 1e-3 — the MLPs
    compute in bf16, and XLA keeps some intermediates in float32 where
    torch rounds each op (the main learning rate is injected small there,
    see test_update_stats_match);
  - one minibatch's gradients: cosine >= 0.999 per parameter group (the
    same bf16 noise, on every entry);
  - a second update started from the JAX state after the first:
    |dp_port - dp_jax| <= 5e-2 |dp_jax| and the same learning rate; its
    stats at rtol 5e-3.
    Parameters are never compared after an update from a fresh Adam
    state: at step 1 Adam moves every entry by +-lr by the SIGN of its
    gradient, so bf16 noise on a near-zero gradient flips whole entries.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deep_tracking_control_tpu.agent import ppo as jppo
from deep_tracking_control_tpu.env.config import AlgorithmCfg
from deep_tracking_control_tpu.models import networks as jnet
from deep_tracking_control_tpu_torch.agent import ppo as tppo
from deep_tracking_control_tpu_torch.convert import (opt_state_from_optax,
                                                     params_from_flax)
from deep_tracking_control_tpu_torch.models import networks as tnet
from tests.xdist_once import once

T, N, Z = 8, 8, 16
SMALL_LR = 1e-7
NET = dict(terrain_latent=32, actor_hidden=(32,), critic_hidden=(32,))
# (fused_joint_step, shuffle_strata, minibatch_perm_granule); the S=1
# cases run here, the S=4 ones in tests/test_torch_update_strata.py
CASES = {"fused_s1_g8": (True, 1, 8), "seq_s1_g1": (False, 1, 1),
         "fused_s4_g1": (True, 4, 1), "seq_s4_g8": (False, 4, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _alg(fused, strata, granule):
    return AlgorithmCfg(num_learning_epochs=2, num_mini_batches=2,
                        fused_joint_step=fused, shuffle_strata=strata,
                        minibatch_perm_granule=granule)


def _base_params():
    """The net's init (jitted), at trained-scale weights, as numpy."""
    jm = jnet.ActorCriticDecoder(**NET)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 53)),
                              jnp.zeros((1, 265)), jnp.zeros((1, 1389)),
                              jnp.zeros((1, 3)), jax.random.PRNGKey(1))
    # trained-scale weights: the orthogonal(0.01) init makes outputs tiny
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "Dense_0" not in jax.tree_util.keystr(p)
        and "kernel" in jax.tree_util.keystr(p) else v, params)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    rng = np.random.default_rng(0)
    jm = jnet.ActorCriticDecoder(**NET)
    params = jax.tree.map(jnp.asarray, once(
        tmp_path_factory, "torch_update_base", _base_params))
    f = np.float32
    mu = rng.normal(0, 0.3, (T, N, 12)).astype(f)
    sigma = rng.uniform(0.8, 1.2, (T, N, 12)).astype(f)
    actions = (mu + sigma * rng.normal(size=(T, N, 12))).astype(f)
    batch = dict(
        obs=rng.normal(size=(T, N, 53)).astype(f),
        next_obs=rng.normal(size=(T, N, 53)).astype(f),
        privileged_obs=rng.normal(size=(T, N, 1389)).astype(f),
        obs_history=rng.normal(size=(T, N, 265)).astype(f),
        base_vel=rng.normal(size=(T, N, 3)).astype(f),
        actions=actions, old_mu=mu, old_sigma=sigma,
        values=rng.normal(size=(T, N)).astype(f),
        returns=rng.normal(size=(T, N)).astype(f),
        advantages=rng.normal(size=(T, N)).astype(f),
        old_log_prob=rng.normal(-15, 1, (T, N)).astype(f))
    jbatch = {k: jnp.asarray(v, jnp.bfloat16 if k in ("privileged_obs",
                                                      "obs_history") else
                             jnp.float32) for k, v in batch.items()}
    return jm, params, jbatch


def _tbatch(jbatch):
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jbatch.items()}


def jax_draws(alg, key):
    """The update's draws, made from its key as agent/ppo.py makes them."""
    S, rows_s, mb_s, G = tppo.shuffle_layout(alg, T, N)
    k_perm, k_upd = jax.random.split(key)
    if S == 1:
        perm = jax.random.permutation(k_perm, T * N // G)[None]
    else:
        perm = jax.vmap(lambda k: jax.random.permutation(k, rows_s // G))(
            jax.random.split(k_perm, S))
    steps = alg.num_learning_epochs * alg.num_mini_batches
    mb = T * N // alg.num_mini_batches
    eps = np.stack([
        np.stack([np.asarray(jax.random.normal(k, (mb, Z), jnp.float32))
                  for k in jax.random.split(ks)])
        for ks in jax.random.split(k_upd, steps)])
    return (torch.from_numpy(np.asarray(perm).astype(np.int64)),
            torch.from_numpy(eps))


def _port(params, alg, states=None):
    net = tnet.ActorCriticDecoder(**NET)
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    ppo = tppo.PPO(net=net, alg=alg)
    if states is not None:
        if "opt_state" in states:
            ppo.optimizer.load_state_dict(states["opt_state"])
            ppo.vae_optimizer.load_state_dict(states["vae_opt_state"])
        ppo.learning_rate = states["learning_rate"]
    return ppo


def _flat(state_dict, names):
    return torch.cat([state_dict[n].reshape(-1) for n in names])


def run_case(base, name):
    """Both packages' updates of case `name` from `base`."""
    jm, params, jbatch = base
    alg = _alg(*CASES[name])
    ppo = jppo.PPO(net=jm, alg=alg)
    main_opt, vae_opt = jppo.make_optimizers(alg)
    upd = jax.jit(ppo.update)
    k1, k2 = jax.random.PRNGKey(2), jax.random.PRNGKey(3)
    lr0 = jnp.asarray(alg.learning_rate)
    # (a) from fresh states with the main learning rate injected at
    # SMALL_LR: the policy params then barely move between the minibatch
    # steps, so every step's stats are read at (nearly) the same params on
    # both sides and Adam's step-1 sign noise cannot feed the later steps
    *_, st1 = upd(params, main_opt.init(params), vae_opt.init(params),
                  jnp.asarray(SMALL_LR), jbatch, k1)
    p1, s1, v1, lr1, _ = upd(params, main_opt.init(params),
                             vae_opt.init(params), lr0, jbatch, k1)
    p2, _, _, lr2, st2 = upd(p1, s1, v1, lr1, jbatch, k2)
    tb = _tbatch(jbatch)
    port1 = _port(params, alg, dict(learning_rate=torch.tensor(SMALL_LR)))
    perm, eps = jax_draws(alg, k1)
    pst1 = port1.update(tb, perm=perm, eps=eps)
    port2 = _port(p1, alg, opt_state_from_optax(
        jax.tree.map(np.asarray, s1), jax.tree.map(np.asarray, v1), lr1))
    perm, eps = jax_draws(alg, k2)
    pst2 = port2.update(tb, perm=perm, eps=eps)
    return dict(alg=alg, jm=jm, params=params, jbatch=jbatch, tb=tb,
                p1=p1, p2=p2, lr1=lr1, lr2=lr2, st1=st1, st2=st2,
                pst1=pst1, port2=port2, pst2=pst2)


@pytest.fixture(scope="module", params=["fused_s1_g8", "seq_s1_g1"])
def case(request, base):
    return run_case(base, request.param)


def test_update_stats_match(case):
    """(a) the nine stats of one update from fresh states (main learning
    rate injected at SMALL_LR, which the adaptive rule lifts to its 1e-5
    floor on both sides)."""
    for k in tppo.STAT_NAMES:
        np.testing.assert_allclose(float(case["pst1"][k]),
                                   float(case["st1"][k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)


def test_second_update_matches(case):
    """(c) from the JAX state after one update (params_from_flax +
    opt_state_from_optax), the port's second update moves the params as
    the JAX one does, and ends at the same learning rate."""
    names = [n for n, _ in case["port2"].net.named_parameters()]
    p1 = _flat(params_from_flax(jax.tree.map(np.asarray, case["p1"])), names)
    p2 = _flat(params_from_flax(jax.tree.map(np.asarray, case["p2"])), names)
    got = torch.cat([p.detach().reshape(-1)
                     for p in case["port2"].net.parameters()])
    d_jax, d_port = p2 - p1, got - p1
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm()) <= 5e-2 * float(d_jax.norm())
    np.testing.assert_allclose(float(case["port2"].learning_rate),
                               float(case["lr2"]), rtol=1e-6)
    # the stats of steps 2.. are read at params that already differ by the
    # bf16 noise above, moved by Adam at the full learning rate: rtol 5e-3
    for k in tppo.STAT_NAMES:
        np.testing.assert_allclose(float(case["pst2"][k]),
                                   float(case["st2"][k]), rtol=5e-3,
                                   atol=1e-6, err_msg=k)


def _jax_losses(jm, alg, mb, k_vae, k_pol):
    """The two loss functions of the JAX update's minibatch step
    (agent/ppo.py:348-438), to differentiate at one point."""
    def vae_loss(p):
        r, v, kl, h = jm.apply(p, mb["obs_history"], mb["privileged_obs"],
                               mb["next_obs"], mb["base_vel"], k_vae,
                               method=jm.vae_losses)
        return r + v + alg.kld_weight * kl + h

    def pol_loss(p):
        mean, std, _, _ = jm.apply(p, mb["obs"], mb["obs_history"],
                                   mb["privileged_obs"], k_pol,
                                   method=jm.act_stats)
        value = jm.apply(p, mb["obs"], mb["privileged_obs"], mb["base_vel"],
                         method=jm.evaluate)
        ratio = jnp.exp(jppo.normal_log_prob(mean, std, mb["actions"])
                        - mb["old_log_prob"])
        adv = mb["advantages"]
        surr = jnp.mean(jnp.maximum(-adv * ratio, -adv * jnp.clip(
            ratio, 1.0 - alg.clip_param, 1.0 + alg.clip_param)))
        v_clip = mb["values"] + jnp.clip(value - mb["values"],
                                         -alg.clip_param, alg.clip_param)
        vl = jnp.mean(jnp.maximum(jnp.square(value - mb["returns"]),
                                  jnp.square(v_clip - mb["returns"])))
        ent = jnp.mean(jppo.normal_entropy(std))
        return surr + alg.value_loss_coef * vl - alg.entropy_coef * ent
    return vae_loss, pol_loss


def _cosines(got, want):
    """Cosine of two gradients per parameter group (the module owning it)."""
    groups = {}
    for n in want:
        g = n.rsplit(".", 2)[0] if "." in n else n
        groups.setdefault(g, []).append(n)
    out = {}
    for g, names in groups.items():
        a = torch.cat([got[n].reshape(-1) for n in names]).double()
        b = torch.cat([want[n].reshape(-1) for n in names]).double()
        if float(b.norm()) > 0:
            out[g] = float(a @ b / (a.norm() * b.norm()))
    return out


def test_minibatch_gradients_match(case):
    """(b) the VAE and policy gradients of the first minibatch at the same
    params, per parameter group."""
    alg, jm, params = case["alg"], case["jm"], case["params"]
    k_upd = jax.random.split(jax.random.PRNGKey(2))[1]
    k_vae, k_pol = jax.random.split(jax.random.split(
        k_upd, alg.num_learning_epochs * alg.num_mini_batches)[0])
    ppo = _port(params, alg)
    perm, eps = jax_draws(alg, jax.random.PRNGKey(2))
    S = tppo.shuffle_layout(alg, T, N)[0]
    mb = ppo.minibatch(ppo.shuffle(case["tb"], perm), 0, S)
    _, _, vae_grads, grads = ppo.joint_grads(mb, eps[0, 0], eps[0, 1])
    jmb = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16
                          if v.dtype == torch.bfloat16 else jnp.float32)
           for k, v in mb.items()}
    vae_loss, pol_loss = _jax_losses(jm, alg, jmb, k_vae, k_pol)
    for fn, opt, tgrads in ((vae_loss, ppo.vae_optimizer, vae_grads),
                            (pol_loss, ppo.optimizer, grads)):
        want = params_from_flax(jax.tree.map(np.asarray,
                                             jax.jit(jax.grad(fn))(params)))
        got = {n: (torch.zeros_like(p) if g is None else g)
               for n, p, g in zip(opt.names, opt.params, tgrads)}
        want = {n: want[n] for n in opt.names}
        cos = _cosines(got, want)
        assert cos and min(cos.values()) >= 0.999, cos


def test_optimizers_match_optax(base):
    """Clip + Adam + the injected learning rate + the VAE mask against
    optax's make_optimizers, 3 steps on identical float32 gradients (one
    step clipped, lr changed between steps)."""
    _, params, _ = base
    alg = AlgorithmCfg()
    main_opt, vae_opt = jppo.make_optimizers(alg)

    @jax.jit
    def jax_step(params, s, vs, g, vg, lr):
        # the VAE step, then the main step at the injected lr (ppo.py:440-497)
        vu, vs = vae_opt.update(vg, vs, params)
        params = optax.apply_updates(params, jppo.mask_non_vae(vu))
        inj = s[1]._replace(hyperparams={**s[1].hyperparams,
                                         "learning_rate": lr})
        u, s = main_opt.update(g, (s[0], inj), params)
        return optax.apply_updates(params, u), s, vs

    s, vs = main_opt.init(params), vae_opt.init(params)
    ppo = _port(params, alg)
    rng = np.random.default_rng(4)
    lrs = (1e-3, 1.5e-3, 6.7e-4)
    for step, (lr, scale) in enumerate(zip(lrs, (0.3, 5.0, 1e-3))):
        g, vg = (jax.tree.map(lambda x: jnp.asarray(
            rng.normal(0, scale / np.sqrt(x.size), x.shape), jnp.float32),
            params) for _ in range(2))
        vg = jppo.mask_non_vae(vg)       # the VAE loss reaches vae only
        params, s, vs = jax_step(params, s, vs, g, vg, jnp.asarray(lr))

        def grads(tree, opt):
            t = params_from_flax(jax.tree.map(np.asarray, tree))
            return [t[n] for n in opt.names]
        ppo.vae_optimizer.step(grads(vg, ppo.vae_optimizer),
                               alg.vae_learning_rate)
        ppo.optimizer.step(grads(g, ppo.optimizer),
                           torch.tensor(lr, dtype=torch.float32))
        want = params_from_flax(jax.tree.map(np.asarray, params))
        for n, p in ppo.net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       atol=1e-7, rtol=1e-6,
                                       err_msg=f"step {step} {n}")
    conv = opt_state_from_optax(jax.tree.map(np.asarray, s),
                                jax.tree.map(np.asarray, vs), lrs[-1])
    for mine, theirs in ((ppo.optimizer.state_dict(), conv["opt_state"]),
                         (ppo.vae_optimizer.state_dict(),
                          conv["vae_opt_state"])):
        assert int(mine["count"]) == int(theirs["count"]) == 3
        for m in ("mu", "nu"):
            assert set(mine[m]) == set(theirs[m])
            for n in mine[m]:
                # atol relative to the tensor's scale: b1*mu + (1-b1)*g
                # cancels to near zero on some entries, where the last-bit
                # difference of the clip factor is all that is left
                want = theirs[m][n].numpy()
                np.testing.assert_allclose(
                    mine[m][n].numpy(), want, rtol=1e-5,
                    atol=1e-6 * float(np.abs(want).max()), err_msg=f"{m} {n}")
