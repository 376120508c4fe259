"""The MLP and recurrent actor-critics of the torch port against the JAX
package: cells, nets, the trajectory helpers, recurrent acting and replay,
and the MLP and recurrent PPO updates.

Weights come from flax through params_from_flax; the same numpy-seeded
inputs and the JAX package's random draws (its action draws, its group or
env permutations, made from its keys as agent/ppo.py makes them) go
through both.  Tolerances, and why:
  - the GRU and LSTM cells and Memory compute in float32 in both
    packages: rtol 1e-5 / atol 1e-6 (only the order of a matmul's sum
    differs);
  - the heads are the bf16 MLPs: max |diff| <= 2% of the output's max
    magnitude, the budget of tests/test_torch_networks.py;
  - the trajectory helpers move values without arithmetic (unpad's add is
    of one value and zeros): exact;
  - the replay against the collection in the port: the same ops on the
    same rows, exact;
  - the updates as tests/test_torch_update.py holds the decoder's: the
    stats of one update from fresh states with the main learning rate
    injected small at rtol 1e-3, then a second update from the JAX state
    after a first: |dp_port - dp_jax| <= 5e-2 |dp_jax|, the same learning
    rate, stats at rtol 5e-3.  Parameters are never compared after an
    update from a fresh Adam state (step 1 moves each entry by +-lr by the
    sign of its gradient).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.agent import ppo as jppo
from deep_tracking_control_tpu.agent import trajectories as jtraj
from deep_tracking_control_tpu.env.config import AlgorithmCfg
from deep_tracking_control_tpu.models import networks as jnet
from deep_tracking_control_tpu_torch.agent import ppo as tppo
from deep_tracking_control_tpu_torch.agent import trajectories as ttraj
from deep_tracking_control_tpu_torch.convert import (opt_state_from_optax,
                                                     params_from_flax)
from deep_tracking_control_tpu_torch.models import networks as tnet

BF16_REL = 0.02
SMALL_LR = 1e-7
RNN = ("gru", "lstm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def _close_bf16(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= BF16_REL * scale + 1e-6, f"{name}: {err} vs max {scale}"


def _close_f32(got, want, name):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _trained_scale(params):
    """Head kernels past the first layer x50: the orthogonal(0.01) init
    makes every head output tiny."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "Dense_0" not in jax.tree_util.keystr(p)
        and "kernel" in jax.tree_util.keystr(p)
        and "Cell" not in jax.tree_util.keystr(p) else v, params)


def _load(tnet_obj, params):
    tnet_obj.load_state_dict(params_from_flax(_np(params)), strict=True)
    return tnet_obj


def _zero_carry(rnn, n, h, lib=jnp):
    z = lib.zeros((n, h))
    return z if rnn == "gru" else (z, lib.zeros((n, h)))


# ---- cells, Memory and the nets --------------------------------------------

@pytest.mark.parametrize("rnn", RNN)
def test_cells_and_memory_match_flax(rnn):
    """flax GRUCell / OptimizedLSTMCell and the JAX Memory against the
    port's cell and Memory over 3 steps from a nonzero carry, element by
    element in float32."""
    from flax import linen as nn
    rng = np.random.default_rng(1)
    N, D, H = 6, 10, 16
    xs = rng.normal(size=(3, N, D)).astype(np.float32)
    c0 = tuple(rng.normal(0, 0.5, (N, H)).astype(np.float32)
               for _ in range(1 if rnn == "gru" else 2))
    c0 = c0[0] if rnn == "gru" else c0
    flax_cell = (nn.GRUCell(features=H) if rnn == "gru"
                 else nn.OptimizedLSTMCell(features=H))
    cell_params = flax_cell.init(jax.random.PRNGKey(0), c0, xs[0])
    port_cell = _load({"gru": tnet.GRUCell, "lstm": tnet.LSTMCell}[rnn](D, H),
                      cell_params)
    jm = jnet.Memory(hidden_size=H, rnn_type=rnn)
    mem_params = jm.init(jax.random.PRNGKey(2), xs[0], c0)
    port_mem = _load(tnet.Memory(D, H, rnn), mem_params)
    jc = jcm = c0
    tc = tcm = _t(c0)
    with torch.no_grad():
        for t in range(3):
            jc, jout = flax_cell.apply(cell_params, jc, xs[t])
            tc, tout = port_cell(tc, torch.from_numpy(xs[t]))
            _close_f32((tc, tout), (jc, jout), f"{rnn} cell step {t}")
            jcm, jmout = jm.apply(mem_params, xs[t], jcm)
            tcm, tmout = port_mem(torch.from_numpy(xs[t]), tcm)
            _close_f32((tcm, tmout), (jcm, jmout), f"{rnn} Memory step {t}")


def _jax_net(kind, **kw):
    if kind == "mlp":
        return jnet.ActorCritic(**kw)
    return jnet.ActorCriticRecurrent(rnn_type=kind, **kw)


def _port_net(kind, **kw):
    if kind == "mlp":
        return tnet.ActorCritic(**kw)
    return tnet.ActorCriticRecurrent(rnn_type=kind, **kw)


@pytest.mark.parametrize("kind", ("mlp",) + RNN)
def test_nets_match_flax(kind):
    """ActorCritic and ActorCriticRecurrent at the PolicyCfg widths (heads
    (512, 256, 128), rnn_hidden_size 256): params_from_flax covers every
    weight (strict load, equal counts); mean and value at the bf16
    budget, std exact, the carries in float32 over 2 steps."""
    rng = np.random.default_rng(2)
    N = 8
    obs = rng.normal(size=(2, N, 53)).astype(np.float32)
    jm = _jax_net(kind)
    args = (obs[0], obs[0])
    if kind != "mlp":
        c = _zero_carry(kind, N, 256)
        c = jax.tree.map(lambda z: z + 0.3, c)
        args += (c, c)
    params = _trained_scale(jm.init(jax.random.PRNGKey(3), *args))
    tm = _load(_port_net(kind), params)
    assert (sum(np.asarray(v).size for v in jax.tree.leaves(params))
            == sum(p.numel() for p in tm.parameters()))
    jc, tc = args[2:], _t(args[2:])        # the carries, () for the MLP
    with torch.no_grad():
        for t in range(1 if kind == "mlp" else 2):
            x = torch.from_numpy(obs[t])
            jout = jm.apply(params, obs[t], obs[t], *jc)
            tout = tm(x, x, *tc)
            _close_bf16(tout[0], jout[0], f"{kind} mean step {t}")
            _close_bf16(tout[2], jout[2], f"{kind} value step {t}")
            np.testing.assert_array_equal(tout[1].numpy(),
                                          np.asarray(jout[1]))
            jc, tc = jout[3:], tout[3:]
            _close_f32(tc, jc, f"{kind} carries step {t}")


# ---- trajectories ----------------------------------------------------------

def test_split_pad_and_unpad_match_jax():
    """split_and_pad_trajectories and unpad_trajectories against the JAX
    package's on the same (T, N, D) block and dones: the same padded
    block and masks, and unpad gives back the block."""
    rng = np.random.default_rng(0)
    for T, N, D, p in ((8, 3, 2, 0.25), (6, 4, 3, 0.3), (5, 2, 1, 0.0)):
        x = rng.normal(size=(T, N, D)).astype(np.float32)
        dones = rng.random((T, N)) < p
        dones[-1, 0] = True
        jp, jmask = jtraj.split_and_pad_trajectories(jnp.asarray(x),
                                                     jnp.asarray(dones))
        tp, tmask = ttraj.split_and_pad_trajectories(torch.from_numpy(x),
                                                     torch.from_numpy(dones))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        back = ttraj.unpad_trajectories(tp, tmask)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jtraj.unpad_trajectories(jp, jmask)))


def test_rnn_replay_resets_carry_like_jax():
    """rnn_replay with a tuple carry against the JAX package's: the carry
    is replaced by the reset carry after the step that ended, and env 0's
    outputs equal per-episode runs from zero."""
    T, N, H = 6, 3, 4
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(T, N, H)).astype(np.float32)
    dones = np.zeros((T, N), dtype=bool)
    dones[2, 0] = dones[4, 1] = dones[0, 2] = True
    reset = (np.zeros((N, H), np.float32), np.full((N, H), 0.5, np.float32))

    def cell(lib):
        def apply(carry, x):
            a, b = carry
            a = 0.5 * a + x
            b = b + a
            return (a, b), (a, b)
        return apply
    jc, jout = jtraj.rnn_replay(cell(jnp), jax.tree.map(jnp.asarray, reset),
                                jnp.asarray(xs), jnp.asarray(dones),
                                jax.tree.map(jnp.asarray, reset))
    tc, tout = ttraj.rnn_replay(cell(torch), _t(reset), torch.from_numpy(xs),
                                torch.from_numpy(dones), _t(reset))
    for g, w in zip(jax.tree.leaves((tc, tout)), jax.tree.leaves((jc, jout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    a = np.zeros(H)
    for t in range(T):
        if t == 3:
            a = np.zeros(H)
        a = 0.5 * a + xs[t, 0]
        np.testing.assert_allclose(tout[0][t, 0].numpy(), a, atol=1e-6)


# ---- recurrent acting and replay -------------------------------------------

def _small_recurrent(rnn, seed=0, obs_dim=10, H=16):
    jm = jnet.ActorCriticRecurrent(num_obs=obs_dim, num_critic_obs=obs_dim,
                                   num_actions=4, rnn_hidden_size=H,
                                   rnn_type=rnn, actor_hidden=(16,),
                                   critic_hidden=(16,))
    c = _zero_carry(rnn, 1, H)
    params = _trained_scale(jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)),
        jnp.zeros((1, obs_dim)), c, c))
    tm = _load(tnet.ActorCriticRecurrent(
        num_obs=obs_dim, num_critic_obs=obs_dim, num_actions=4,
        rnn_hidden_size=H, rnn_type=rnn, actor_hidden=(16,),
        critic_hidden=(16,)), params)
    return jm, params, tm


@pytest.mark.parametrize("rnn", RNN)
def test_act_recurrent_and_replay(rnn):
    """A 5-step collection with act_recurrent (JAX's action draws fed in)
    and the carries zeroed at dones, then the replay: against the JAX
    package's act_recurrent and _replay (heads at the bf16 budget, carries
    in float32), and the port's replay equal to its own collection (the
    counterpart of tests/test_recurrent_runner.py:78)."""
    T, N, H = 5, 4, 16
    jm, params, tm = _small_recurrent(rnn)
    jp = jppo.PPO(net=jm, alg=AlgorithmCfg(), policy_kind="recurrent")
    tp = tppo.PPO(net=tm, alg=AlgorithmCfg(), policy_kind="recurrent")
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(T, N, 10)).astype(np.float32)
    dones = rng.random((T, N)) < 0.3
    dones[1, 0] = True
    init = jax.tree.map(lambda z: z + 0.2, _zero_carry(rnn, N, H))
    jca = jcc = init
    tca = tcc = _t(init)
    rows = []
    for t in range(T):
        key = jax.random.PRNGKey(10 + t)
        ja, jca, jcc = jp.act_recurrent(params, obs[t], jca, jcc, key)
        eps = np.array(jax.random.normal(key, (N, 4)))
        ta, tca, tcc = tp.act_recurrent(torch.from_numpy(obs[t]), tca, tcc,
                                        eps_a=torch.from_numpy(eps))
        for k in ("mu", "values", "actions"):
            _close_bf16(ta[k], ja[k], f"{rnn} step {t} {k}")
        _close_f32((tca, tcc), (jca, jcc), f"{rnn} step {t} carries")
        rows.append(ta)
        reset = dones[t][:, None]
        jca, jcc = (jax.tree.map(lambda c: jnp.where(reset, 0.0, c), x)
                    for x in (jca, jcc))
        tca, tcc = (ttraj.tree_map(lambda c: torch.where(
            torch.from_numpy(reset), 0.0, c), x) for x in (tca, tcc))
    jmean, _, jval = jp._replay(params, obs, dones, init, init)
    with torch.no_grad():
        tmean, tstd, tval = tp.replay(torch.from_numpy(obs),
                                      torch.from_numpy(dones), _t(init),
                                      _t(init))
    _close_bf16(tmean, jmean, f"{rnn} replay mean")
    _close_bf16(tval, jval, f"{rnn} replay value")
    assert torch.equal(tmean, torch.stack([r["mu"] for r in rows]))
    assert torch.equal(tval, torch.stack([r["values"] for r in rows]))
    assert torch.equal(tstd, torch.stack([r["sigma"] for r in rows]))


# ---- the MLP and recurrent updates -----------------------------------------

T, N = 6, 8


def _batch(kind, rng):
    f = np.float32
    mu = rng.normal(0, 0.3, (T, N, 4)).astype(f)
    sigma = rng.uniform(0.8, 1.2, (T, N, 4)).astype(f)
    b = dict(obs=rng.normal(size=(T, N, 10)).astype(f),
             actions=(mu + sigma * rng.normal(size=(T, N, 4))).astype(f),
             old_mu=mu, old_sigma=sigma,
             values=rng.normal(size=(T, N)).astype(f),
             returns=rng.normal(size=(T, N)).astype(f),
             advantages=rng.normal(size=(T, N)).astype(f),
             old_log_prob=rng.normal(-5, 1, (T, N)).astype(f))
    if kind == "mlp":
        # the JAX update reads these (its "mlp" policy ignores them)
        b.update(obs_history=np.zeros((T, N, 1), f),
                 privileged_obs=np.zeros((T, N, 1), f),
                 base_vel=np.zeros((T, N, 3), f))
    else:
        b["dones"] = rng.random((T, N)) < 0.2
        c = [rng.normal(0, 0.3, (N, 16)).astype(f) for _ in range(4)]
        b["init_carry_a"] = c[0] if kind == "gru" else (c[0], c[1])
        b["init_carry_c"] = c[2] if kind == "gru" else (c[2], c[3])
    return b


def _jax_draws(kind, alg, key):
    """The update's draws, made from its key as agent/ppo.py makes them:
    the group permutation (mlp, S=1) or the env permutation of each epoch
    (recurrent, ppo.py:179-181)."""
    k_perm, _ = jax.random.split(key)
    if kind == "mlp":
        G = tppo.shuffle_layout(alg, T, N)[3]
        return torch.from_numpy(np.asarray(
            jax.random.permutation(k_perm, T * N // G))[None].astype(np.int64))
    nmb = alg.num_mini_batches
    return torch.from_numpy(np.concatenate([
        np.asarray(jax.random.permutation(k, N))[:nmb * (N // nmb)]
        .reshape(nmb, N // nmb)
        for k in jax.random.split(k_perm, alg.num_learning_epochs)]))


@pytest.fixture(scope="module", params=("mlp",) + RNN)
def updated(request):
    """One JAX update from fresh states at SMALL_LR, one at the default
    rate and a second from its state; the port's first (SMALL_LR) and
    second (from the converted JAX state) on the same batch and draws."""
    kind = request.param
    alg = AlgorithmCfg(num_learning_epochs=2, num_mini_batches=2,
                       minibatch_perm_granule=4)
    if kind == "mlp":
        jm = jnet.ActorCritic(num_obs=10, num_critic_obs=10, num_actions=4,
                              actor_hidden=(16,), critic_hidden=(16,))
        params = _trained_scale(jm.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 10)),
                                        jnp.zeros((1, 10))))

        def port_net():
            return tnet.ActorCritic(num_obs=10, num_critic_obs=10,
                                    num_actions=4, actor_hidden=(16,),
                                    critic_hidden=(16,))
    else:
        jm, params, _ = _small_recurrent(kind)

        def port_net():
            return tnet.ActorCriticRecurrent(
                num_obs=10, num_critic_obs=10, num_actions=4,
                rnn_hidden_size=16, rnn_type=kind, actor_hidden=(16,),
                critic_hidden=(16,))
    jp = jppo.PPO(net=jm, alg=alg, policy_kind=(
        "mlp" if kind == "mlp" else "recurrent"))
    main_opt, vae_opt = jppo.make_optimizers(alg)
    batch = _batch(kind, np.random.default_rng(5))
    jbatch = jax.tree.map(jnp.asarray, batch)
    k1, k2 = jax.random.PRNGKey(2), jax.random.PRNGKey(3)
    lr0 = jnp.asarray(alg.learning_rate)
    if kind == "mlp":
        upd = jax.jit(jp.update)
        *_, st1 = upd(params, main_opt.init(params), vae_opt.init(params),
                      jnp.asarray(SMALL_LR), jbatch, k1)
        p1, s1, v1, lr1, _ = upd(params, main_opt.init(params),
                                 vae_opt.init(params), lr0, jbatch, k1)
        p2, _, _, lr2, st2 = upd(p1, s1, v1, lr1, jbatch, k2)
    else:
        upd = jax.jit(jp.update_recurrent)
        *_, st1 = upd(params, main_opt.init(params), jnp.asarray(SMALL_LR),
                      jbatch, k1)
        p1, s1, lr1, _ = upd(params, main_opt.init(params), lr0, jbatch, k1)
        p2, _, lr2, st2 = upd(p1, s1, lr1, jbatch, k2)
        v1 = None
    tbatch = _t(batch)

    def port(p, kind_, states):
        ppo = tppo.PPO(net=_load(port_net(), p), alg=alg,
                       policy_kind="mlp" if kind_ == "mlp" else "recurrent")
        if "opt_state" in states:
            ppo.optimizer.load_state_dict(states["opt_state"])
            ppo.vae_optimizer.load_state_dict(states["vae_opt_state"])
        ppo.learning_rate = states["learning_rate"]
        return ppo

    def run(ppo, key):
        draws = _jax_draws(kind, alg, key)
        if kind == "mlp":
            return ppo.update(tbatch, perm=draws)
        return ppo.update_recurrent(tbatch, env_idx=draws)
    port1 = port(params, kind, dict(learning_rate=torch.tensor(SMALL_LR)))
    pst1 = run(port1, k1)
    port2 = port(p1, kind, opt_state_from_optax(
        _np(s1), None if v1 is None else _np(v1), lr1))
    pst2 = run(port2, k2)
    return dict(kind=kind, st1=st1, pst1=pst1, st2=st2, pst2=pst2, p1=p1,
                p2=p2, lr2=lr2, port2=port2)


def test_update_matches_jax(updated):
    """The MLP update (no VAE step: its four VAE stats zero) and
    update_recurrent (GRU and LSTM) against the JAX package's: the nine
    stats of one update from fresh states, then a second update from the
    JAX state after a first moves the params as the JAX one does and ends
    at the same learning rate."""
    u = updated
    for k in tppo.STAT_NAMES:
        np.testing.assert_allclose(float(u["pst1"][k]), float(u["st1"][k]),
                                   rtol=1e-3, atol=1e-6,
                                   err_msg=f"{u['kind']} first {k}")
    for k in ("recons_loss", "vel_loss", "kld_loss", "height_loss"):
        assert float(u["pst1"][k]) == 0.0
    names = [n for n, _ in u["port2"].net.named_parameters()]
    p1, p2 = (torch.cat([params_from_flax(_np(p))[n].reshape(-1)
                         for n in names]) for p in (u["p1"], u["p2"]))
    got = torch.cat([p.detach().reshape(-1)
                     for p in u["port2"].net.parameters()])
    d_jax, d_port = p2 - p1, got - p1
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm()) <= 5e-2 * float(d_jax.norm())
    np.testing.assert_allclose(float(u["port2"].learning_rate),
                               float(u["lr2"]), rtol=1e-6)
    for k in tppo.STAT_NAMES:
        np.testing.assert_allclose(float(u["pst2"][k]), float(u["st2"][k]),
                                   rtol=5e-3, atol=1e-6,
                                   err_msg=f"{u['kind']} second {k}")
