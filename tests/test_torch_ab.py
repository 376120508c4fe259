"""The port's A/B training-outcome scripts (scripts/ab_granule.py and
ab_fused_step.py) against the JAX package's, on the CPU.

Each script's variant configs equal the JAX scripts' `dataclasses.replace`
of the JAX registry's lite3_dtc, field by field.  Each variant then runs
lite3_dtc at 8 envs for one iteration (the full task and net; ~7 s a
variant here): the two variants of a script share the first collect, so
their iteration-0 curve points are equal (exactly: the same computation
on the same device), and part after the first update.  The fused and
sequential first updates, from one state and one batch, part by under
half the update's size (the rule of the JAX package's
tests/test_ppo.py::test_fused_joint_step_close_to_sequential).  The
scripts print the JAX scripts' lines, and stop without a card unless the
CPU is asked for.  The log reader (scripts/lr_stall.py) reads the floor
from the runner's log lines.
"""
import dataclasses
import math
import re

import pytest
import torch

from deep_tracking_control_tpu.tasks import registry as jregistry
from deep_tracking_control_tpu_torch.agent.ppo import PPO
from deep_tracking_control_tpu_torch.scripts import (ab_common, ab_fused_step,
                                                     ab_granule, lr_stall)

N = 8
SCRIPTS = {"granule": (ab_granule, "minibatch_perm_granule"),
           "fused": (ab_fused_step, "fused_joint_step")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in parallel workers that would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variant_cfgs(field, value, num_envs, seed):
    """The configs that the JAX script's run_variant builds."""
    task_cfg, train_cfg = jregistry.get_cfgs("lite3_dtc")
    task_cfg = dataclasses.replace(
        task_cfg, env=dataclasses.replace(task_cfg.env, num_envs=num_envs))
    train_cfg = dataclasses.replace(
        train_cfg,
        runner=dataclasses.replace(train_cfg.runner, seed=seed),
        algorithm=dataclasses.replace(train_cfg.algorithm, **{field: value}))
    return task_cfg, train_cfg


@pytest.mark.parametrize("script,value", [("granule", 1), ("granule", 16),
                                          ("fused", False), ("fused", True)])
def test_variant_cfgs_equal_jax(script, value):
    mod, field = SCRIPTS[script]
    assert value in mod.VARIANTS
    for num_envs, seed in ((4096, 1), (N, 3)):
        got = mod.variant_cfgs(value, num_envs, seed)
        want = _jax_variant_cfgs(field, value, num_envs, seed)
        for g, w in zip(got, want):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)


def _params(runner):
    return torch.cat([p.detach().reshape(-1).clone()
                      for p in runner.net.parameters()])


@pytest.fixture(scope="module")
def learned(tmp_path_factory):
    """script -> each variant at N envs: its curve after learn(1), its
    params before and after (each script run once, on first use)."""
    runs = {}

    def get(script):
        if script not in runs:
            mod = SCRIPTS[script][0]
            runs[script] = {}
            for value in mod.VARIANTS:
                rec = ab_common.Recorder()
                runner = ab_common.variant_runner(
                    *mod.variant_cfgs(value, N), "cpu",
                    str(tmp_path_factory.mktemp("ab")), rec)
                before = _params(runner)
                runner.learn(1, init_at_random_ep_len=True)
                runs[script][value] = dict(rec=rec, before=before,
                                           after=_params(runner))
        return runs[script]
    return get


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_variants_share_the_first_collect_then_part(script, learned):
    a, b = learned(script).values()
    # the iteration-0 point comes from the first collect: equal, exactly
    assert 0 in a["rec"].rew and 0 in a["rec"].len
    assert a["rec"].rew == b["rec"].rew and a["rec"].len == b["rec"].len
    assert torch.equal(a["before"], b["before"])
    for r in (a, b):
        assert bool(torch.isfinite(r["after"]).all())
        assert not torch.equal(r["after"], r["before"])
    assert not torch.equal(a["after"], b["after"])


def _tiny_net_and_batch(T=4, N=4):
    """The net (flax init, key 0) and batch of the JAX package's
    tests/test_ppo.py `_tiny_net_and_batch`, in the port."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from deep_tracking_control_tpu.models.networks import (
        ActorCriticDecoder as JNet)
    from deep_tracking_control_tpu_torch.convert import params_from_flax
    from deep_tracking_control_tpu_torch.models.networks import (
        ActorCriticDecoder)
    widths = dict(num_obs=53, num_privileged_obs=1389, num_actions=12,
                  obs_history_dim=265, terrain_dim=693, terrain_latent=32,
                  actor_hidden=(32,), critic_hidden=(32,))
    params = jax.jit(JNet(**widths).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 53)), jnp.zeros((1, 265)),
        jnp.zeros((1, 1389)), jnp.zeros((1, 3)), jax.random.PRNGKey(1))
    net = ActorCriticDecoder(**widths)
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    shapes = dict(obs=53, next_obs=53, privileged_obs=1389, obs_history=265,
                  base_vel=3, actions=12, values=None, returns=None,
                  advantages=None, old_log_prob=None, old_mu=12)
    batch = {k: rng.normal(size=(T, N) + ((d,) if d else ()))
             for k, d in shapes.items()}
    batch["old_mu"] = batch["old_mu"] * 0.1
    batch["old_sigma"] = np.ones((T, N, 12))
    return net, {k: torch.tensor(v, dtype=torch.float32)
                 for k, v in batch.items()}


def test_fused_first_update_close_to_sequential():
    """The rule of the JAX package's
    tests/test_ppo.py::test_fused_joint_step_close_to_sequential on the
    port, at its net, batch and schedule (2 epochs x 2 minibatches): from
    one state and one batch, the fused first update drifts from the
    sequential one by under half the update (L2 over all params), and
    with the main optimizer frozen (lr 0, fixed schedule) the VAE params
    move the same in both orders (rtol 1e-5, atol 1e-7).  At the A/B
    scripts' widths and 5 x 4 schedule the drift grows in both packages
    (`python -m tests.fused_step_drift`)."""
    net, batch = _tiny_net_and_batch()
    before = {k: v.clone() for k, v in net.state_dict().items()}

    def run(fused, **frozen):
        net.load_state_dict(before)
        alg = ab_fused_step.variant_cfgs(fused, N)[1].algorithm
        alg = dataclasses.replace(alg, num_learning_epochs=2,
                                  num_mini_batches=2, **frozen)
        PPO(net=net, alg=alg).update(batch, torch.Generator().manual_seed(7))
        return {k: v.clone() for k, v in net.state_dict().items()}

    def norm(a, b):
        return float(torch.cat([(a[k] - b[k]).reshape(-1)
                                for k in a]).norm())
    seq, fused = run(False), run(True)
    assert all(bool(torch.isfinite(v).all()) for v in fused.values())
    update, drift = norm(seq, before), norm(fused, seq)
    assert update > 0
    assert drift < 0.5 * update, (drift, update)
    frozen = dict(learning_rate=0.0, schedule="fixed")
    seq0, fused0 = run(False, **frozen), run(True, **frozen)
    vae = [k for k in seq0 if k.startswith("vae.")]
    assert vae and any(not torch.equal(seq0[k], before[k]) for k in vae)
    for k in vae:
        torch.testing.assert_close(fused0[k], seq0[k], rtol=1e-5, atol=1e-7)


JAX_HEADERS = {
    "granule": f"{'it':>6s} {'rew G=1':>10s} {'rew G=16':>10s} "
               f"{'len G=1':>10s} {'len G=16':>10s}",
    "fused": f"{'it':>6s} {'rew seq':>10s} {'rew fused':>10s} "
             f"{'len seq':>10s} {'len fused':>10s}"}
JAX_TITLES = {"granule": ("=== granule 1 ===", "=== granule 16 ==="),
              "fused": ("=== fused_joint_step=False ===",
                        "=== fused_joint_step=True ===")}
JAX_TAILS = {"granule": (r"wall: G=1 \d+\.\d+s  G=16 \d+\.\d+s "
                         r"\([+-]\d+\.\d% faster with G=16\)",
                         r"final rewards: G=1 -?\d+\.\d{3} vs G=16 "
                         r"-?\d+\.\d{3}"),
             "fused": (r"wall: seq \d+\.\d+s  fused \d+\.\d+s "
                       r"\([+-]\d+\.\d% faster fused\)",
                       r"final rewards: seq -?\d+\.\d{3} vs fused "
                       r"-?\d+\.\d{3}")}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_main_prints_the_jax_lines(script, capsys):
    SCRIPTS[script][0].main(["--iters", "1", "--num_envs", str(N),
                             "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    for title in JAX_TITLES[script]:
        assert title in lines
    head = lines.index(JAX_HEADERS[script])
    row = lines[head + 1].split()
    assert row[0] == "0" and len(row) == 5
    assert all(math.isfinite(float(x)) for x in row)
    wall, final = JAX_TAILS[script]
    assert lines[head + 2] == ""
    assert re.fullmatch(wall, lines[head + 3]), lines[head + 3]
    assert re.fullmatch(final, lines[head + 4]), lines[head + 4]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_no_card_stops_before_a_run(script, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        SCRIPTS[script][0].main([])
    assert str(e.value) == ("no CUDA device: pass --device cpu to run on "
                            "the CPU")
    assert capsys.readouterr().out == ""


def test_lr_stall_reads_the_log_lines():
    def line(it, rew, ln, lr):
        return (f"it {it:6d} | fps {1000:9d} | rew {rew:8.3f} | "
                f"len {ln:7.1f} | vloss {0.1:8.4f} | surr {0.0:8.4f} | "
                f"lr {lr:.1e}")
    walks = [line(i, 0.1 * i, 10.0 + i, 1e-3) for i in range(0, 210, 10)]
    # 1.04e-5 prints as the floor does: the reading is of the printed lr
    stalls = ([line(i, -0.5, 30.0, 2e-4) for i in range(0, 40, 10)]
              + [line(40, -0.5, 25.0, 1e-5), line(50, -0.4, 60.0, 1.5e-5)]
              + [line(i, -0.4, 20.0, 1.04e-5) for i in range(60, 110, 10)])
    runs = lr_stall.split_runs(["=== granule 1 ===", "noise", *walks,
                                "=== granule 16 ===", *stalls])
    assert [r[0] for r in runs] == ["granule 1", "granule 16"]
    walk, stall = (lr_stall.reading(p) for _, p in runs)
    assert walk["first_floor"] is None and not walk["stalled"]
    assert walk["read"][200] == (20.0, 210.0) and walk["last_it"] == 200
    assert stall["first_floor"] == 40 and not stall["stays"]
    assert stall["floor_from"] == 60 and stall["stalled"]
    assert stall["read"][0] == (-0.5, 30.0)
    assert math.isnan(stall["read"][200][0]) and stall["read"][100] == (
        -0.4, 20.0)
    # a single run of train.py: no title line; long episodes do not stall
    (_, points), = lr_stall.split_runs(
        [line(0, 0.0, 10.0, 1e-5), line(10, 1.0, 80.0, 1e-5)], name="log")
    r = lr_stall.reading(points)
    assert r["stays"] and r["floor_from"] == 0 and not r["stalled"]
