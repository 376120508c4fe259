"""The port's env axis sharded over torch.distributed ranks (parallel/).

On this host each sharded run is two gloo ranks on the CPU, spawned once
per module fixture as processes of this file (``python -m
tests.test_torch_parallel JOB RANK WORLD DIR``), which import torch and
the port only; the JAX side runs in the test process, on a 2-device mesh
of the 8 CPU devices that tests/conftest.py provides.  Sizes: lite3_dtc at
16 envs (8 a rank), decimation 2, a 2x2 terrain with border 4.0, T=4,
tiny nets (terrain_latent 32, hidden (32,)).

  * No process: `shard_tree` splits every leaf of a real env state and
    params tree on the axis that the JAX package's `_spec_for_leaf`
    shards; `shuffle_layout`'s rules over W ranks; the noise kernels' plain
    versions at a row offset are the rows of the full draw, bit for bit.
  * Job A (against JAX): (a) one env step of each rank's half (obs noise
    and pushes off, the JAX draws injected) from a state at the command
    curriculum's gate with envs timing out on both ranks, against the JAX
    step on the mesh (budgets of tests/test_torch_env.py: physics atol
    2e-5 / rtol 1e-5, obs and rewards 1e-4; the reset envs' fresh draws
    are the generator's, so only their deterministic fields), and against
    the port's unsharded step from the same generator seed, exactly; (b)
    the CE-net's filtered logvar and its gradients against JAX's
    cenet_stats and jax.grad on the global batch, with outliers and every
    value tied across the ranks (logvar at the bf16 budget of
    tests/test_torch_networks.py, 2e-2 of its scale; gradients cosine
    >= 0.999 per parameter, tests/test_torch_update.py's budget); (c) the
    fused decoder update at shuffle_strata 2 and 4 and (d) a small GRU's
    update_recurrent (its second update's draw puts whole minibatches in
    one rank's block, so each rank also steps on a minibatch of none of
    its envs), the JAX draws injected, as tests/test_torch_update.py
    and test_torch_policies.py hold them: the stats of an update from
    fresh states at rtol 1e-3, then a second from the JAX state moves the
    params within 5e-2 of the JAX move and ends at its learning rate.
  * Job B (port against port, the port's own draws): learn(2) at W=2
    against W=1 at shuffle_strata 2 (iteration-1 value, surrogate,
    reconstruction and height losses within rtol 2e-3 / atol 1e-5, the
    JAX package's budget in tests/test_multichip_equiv.py), params and
    generators equal on both ranks bit for bit; a checkpoint written at
    W=1 loads at W=2 and its next iteration matches the W=1 run that went
    on; one written at W=2 loads at W=1 with the ranks' optimizer and
    generator states, iteration and env state; scripts.train under the
    ranks' environment writes its checkpoints from rank 0 alone (and,
    without a card, stops unless --device cpu is given).
  * A rank that fails ends both ranks and fails the test with its output.
"""
import dataclasses
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_tracking_control_tpu_torch.agent import ppo as tppo
from deep_tracking_control_tpu_torch.env import cuda_obs
from deep_tracking_control_tpu_torch.env.config import AlgorithmCfg
from deep_tracking_control_tpu_torch.ops import cuda_rng
from deep_tracking_control_tpu_torch.parallel import mesh as pmesh

REPO = Path(__file__).resolve().parent.parent
N, W, T = 16, 2, 4
NET = dict(terrain_latent=32, actor_hidden=(32,), critic_hidden=(32,))
SMALL_LR = 1e-7
STRATA = (2, 4)
JOB_TIMEOUT = 600          # seconds; a failing rank ends its job at once
PHYS = dict(atol=2e-5, rtol=1e-5)
OBS = dict(atol=1e-4, rtol=1e-4)
MULTICHIP = dict(rtol=2e-3, atol=1e-5)
SHARD_STATS = ("value_loss", "surrogate_loss", "recons_loss", "height_loss")
# the key of the GRU's second update: its second epoch puts each minibatch
# wholly in one rank's block, so each rank replays no env in one minibatch
EMPTY_SPLIT_KEY = 3120


# ---------------------------------------------------------------------------
# configurations and helpers shared by the test process and the ranks
# ---------------------------------------------------------------------------
def tiny_cfgs(reg, strata=None, quiet=False, schedule=None):
    task, train = reg.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=N),
        control=dataclasses.replace(task.control, decimation=2),
        terrain=dataclasses.replace(task.terrain, num_rows=2, num_cols=2,
                                    border_size=4.0, max_init_terrain_level=1))
    if quiet:
        # obs noise and pushes off; the command curriculum on (no
        # registry task runs it), with the tracking reward it reads
        rw = task.rewards
        task = dataclasses.replace(
            task, noise=dataclasses.replace(task.noise, add_noise=False),
            domain_rand=dataclasses.replace(task.domain_rand,
                                            push_robots=False),
            commands=dataclasses.replace(task.commands, curriculum=True),
            rewards=dataclasses.replace(rw, scales=dataclasses.replace(
                rw.scales, tracking_lin_vel=1.0)))
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(train.policy, terrain_latent=32,
                                   actor_hidden_dims=(32,),
                                   critic_hidden_dims=(32,)),
        runner=dataclasses.replace(train.runner, num_steps_per_env=T),
        algorithm=dataclasses.replace(
            train.algorithm, shuffle_strata=(train.algorithm.shuffle_strata
                                             if strata is None else strata),
            **(schedule or {})))
    return task, train


def update_alg(strata):
    return AlgorithmCfg(num_learning_epochs=2, num_mini_batches=2,
                        shuffle_strata=strata, minibatch_perm_granule=4)


def recurrent_alg():
    return AlgorithmCfg(num_learning_epochs=2, num_mini_batches=2)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def local(x, shard, axis=1):
    """A rank's envs of a (T, N, ...) array (axis 1) or an (N, ...) one."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return x.narrow(axis, shard.row0, shard.n_local)


# the update schedule of tests/test_multichip_equiv.py, whose budget job B
# holds: its iteration-1 stats are read over two minibatch steps.  Over the
# registry's 5 x 4 steps Adam amplifies the bf16 reduction-order noise of
# a tiny net (first step within 1e-6, the eighth's height loss 7% off)
MULTICHIP_SCHEDULE = dict(num_learning_epochs=1, num_mini_batches=2)


def runner(shard, strata, log_dir=None):
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from deep_tracking_control_tpu_torch.tasks import registry
    task, train = tiny_cfgs(registry, strata, schedule=MULTICHIP_SCHEDULE)
    return OnPolicyRunner(LeggedEnv(task, device="cpu", shard=shard), train,
                          log_dir=log_dir)


def state_of(r):
    return dict(params={k: v.clone() for k, v in r.net.state_dict().items()},
                generator=r.generator.get_state(),
                opt=r.ppo.optimizer.state_dict(),
                vae_opt=r.ppo.vae_optimizer.state_dict(),
                lr=r.ppo.learning_rate.clone(),
                iter=r.current_learning_iteration,
                env_state=clone(r.env_state))


# ---------------------------------------------------------------------------
# the ranks' jobs
# ---------------------------------------------------------------------------
def job_a(shard, root):
    """Against JAX: (a) an env step, (b) the CE-net stats and gradients,
    (c) the decoder update at each stratum count, (d) update_recurrent."""
    from deep_tracking_control_tpu_torch.convert import env_from_jax
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.models import networks as tnet
    from deep_tracking_control_tpu_torch.tasks import registry
    inp = torch.load(root / "inputs.pt", weights_only=False)
    out = {}
    e = inp["env"]
    env = LeggedEnv(tiny_cfgs(registry, quiet=True)[0], device="cpu",
                    shard=shard)
    params, state = env_from_jax(e["params"], e["state"], e["grid_height"],
                                 env, e["terrain_origins"], shard=shard)
    draws = dict(lag=e["lag"],
                 height_noise=local(e["height_noise"], shard, 0).contiguous())
    new_state, step_out = env.step(
        params, state, local(e["actions"], shard, 0).contiguous(),
        torch.Generator().manual_seed(e["seed"]), draws=draws)
    out["step"] = dict(state=clone(new_state), out=clone(step_out))

    c = inp["cenet"]
    net = tnet.ActorCriticDecoder(**NET, shard=shard)
    net.load_state_dict(c["params"])
    hist = local(c["hist"], shard, 0)
    with torch.enable_grad():
        mu, lv = net.vae.cenet_stats(hist)
        loss = ((local(c["w_lv"], shard, 0) * lv).sum()
                + (local(c["w_mu"], shard, 0) * mu).sum())
        names = [n for n, p in net.named_parameters() if p.requires_grad
                 and n.startswith(("vae.cenet_encoder", "vae.latent"))]
        grads = torch.autograd.grad(
            loss, [dict(net.named_parameters())[n] for n in names])
    out["cenet"] = dict(logvar=lv.detach(), mu=mu.detach(),
                        grads=dict(zip(names, grads)))

    def ppo(state_dict, alg, kind, states):
        m = (tnet.ActorCriticDecoder(**NET, shard=shard)
             if kind == "decoder" else
             tnet.ActorCriticRecurrent(num_obs=10, num_critic_obs=10,
                                       num_actions=4, rnn_hidden_size=16,
                                       rnn_type="gru", actor_hidden=(16,),
                                       critic_hidden=(16,)))
        m.load_state_dict(state_dict)
        p = tppo.PPO(net=m, alg=alg, policy_kind=kind, shard=shard)
        if "opt_state" in states:
            p.optimizer.load_state_dict(states["opt_state"])
            p.vae_optimizer.load_state_dict(states["vae_opt_state"])
        p.learning_rate = states["learning_rate"]
        return p

    def named(p):
        return {n: x.detach().clone() for n, x in p.net.named_parameters()}
    for S in STRATA:
        u = inp["update"][S]
        alg = update_alg(S)
        batch = {k: local(v, shard) for k, v in u["batch"].items()}
        p1 = ppo(u["params"], alg, "decoder",
                 dict(learning_rate=torch.tensor(SMALL_LR)))
        st1 = p1.update(batch, perm=u["perm1"], eps=u["eps1"])
        p2 = ppo(u["p1"], alg, "decoder", u["states1"])
        st2 = p2.update(batch, perm=u["perm2"], eps=u["eps2"])
        out[f"update{S}"] = dict(st1=st1, st2=st2, params=named(p2),
                                 lr=p2.learning_rate.clone())
    u = inp["recurrent"]
    batch = {k: local(v, shard, 0 if k.startswith("init_carry") else 1)
             for k, v in u["batch"].items()}
    p1 = ppo(u["params"], recurrent_alg(), "recurrent",
             dict(learning_rate=torch.tensor(SMALL_LR)))
    st1 = p1.update_recurrent(batch, env_idx=u["idx1"])
    p2 = ppo(u["p1"], recurrent_alg(), "recurrent", u["states1"])
    st2 = p2.update_recurrent(batch, env_idx=u["idx2"])
    out["recurrent"] = dict(st1=st1, st2=st2, params=named(p2),
                            lr=p2.learning_rate.clone())
    return out


def job_b(shard, root):
    """Port against port: learn(2) at shuffle_strata 2; the W=1 checkpoint
    loaded and one more iteration; a checkpoint written at W=2; the train
    script under the ranks' environment."""
    out = {}
    r = runner(shard, 2)
    out["rows"] = r.learn(2)
    out["trained"] = state_of(r)
    r = runner(shard, 2)
    r.load(str(root / "w1.pt"))
    out["resumed"] = r.learn(1)
    r.save(str(root / "w2.pt"))
    out["saved"] = state_of(r)
    from deep_tracking_control_tpu_torch.scripts import train as script
    from deep_tracking_control_tpu_torch.tasks import registry
    os.environ.update(WORLD_SIZE=str(shard.world), RANK=str(shard.rank),
                      LOCAL_RANK=str(shard.rank))
    script.get_cfgs = lambda name: tiny_cfgs(registry)
    run = script.main(["--task", "lite3_dtc", "--device", "cpu",
                       "--num_envs", str(N), "--max_iterations", "1",
                       "--log_root", str(root / "logs")])
    out["script"] = dict(log_dir=run.log_dir, n_local=run.env.num_envs,
                         iter=run.current_learning_iteration)
    return out


def job_fail(shard, root):
    """Rank 1 raises; rank 0 waits for it at a collective."""
    if shard.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    from deep_tracking_control_tpu_torch.parallel import distributed as pdist
    pdist.barrier()
    return {}


JOBS = dict(a=job_a, b=job_b, fail=job_fail)


def _rank_main(job, rank, world, root):
    torch.set_num_threads(1)
    from deep_tracking_control_tpu_torch.parallel import distributed as pdist
    root = Path(root)
    pdist.initialize(backend="gloo", init_method=f"file://{root}/store",
                     world_size=world, rank=rank, device_type="cpu")
    out = JOBS[job](pdist.global_shard(N), root)
    torch.save(out, root / f"rank{rank}.pt")
    pdist.barrier()
    pdist.shutdown()


class RankFailed(AssertionError):
    pass


def start_job(job, root, extra_env=None):
    """The job's rank processes, started (each with its log file)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(extra_env or {}),
           "PYTHONPATH": os.pathsep.join(
               [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs = []
    for r in range(W):
        log = open(root / f"rank{r}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_parallel", job, str(r),
             str(W), str(root)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def finish_job(procs, root, timeout=JOB_TIMEOUT):
    """Wait for every rank; a rank that exits non-zero, or a job past
    `timeout`, ends all ranks and raises RankFailed with the output of
    each.  Returns the ranks' results."""
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]}" if bad else f"timeout {timeout} s"
                break
            time.sleep(0.1)
        else:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
            failed = f"rank {bad[0]}" if bad else None
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for r, (p, log) in enumerate(procs):
        log.seek(0)
        texts.append(f"--- rank {r} (exit {p.returncode}) ---\n"
                     + "".join(log.readlines()[-30:]))
        log.close()
    if failed is not None:
        raise RankFailed(f"{failed} failed\n" + "\n".join(texts))
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# no process
# ---------------------------------------------------------------------------
def test_shard_tree_splits_the_leaves_jax_shards():
    """Every leaf of a real env (params, state) and of the runner's episode
    bookkeeping: the axis `shard_tree` splits is the one JAX's
    `_spec_for_leaf` shards, and a rank's block is that axis's slice."""
    import jax
    from deep_tracking_control_tpu.parallel import mesh as jmesh
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.tasks import registry
    env = LeggedEnv(tiny_cfgs(registry)[0], device="cpu")
    params, state = env.init(torch.Generator().manual_seed(0))
    tree = dict(params={k: v for k, v in params.items() if k != "terrain"},
                state=state, log=dict(cur_reward_sum=torch.zeros(N)))
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.asarray(t), tree))[0]
    shard = pmesh.make_shard(N, W, 1)
    split = pmesh.shard_tree(tree, shard)
    seen = {"none": 0, "first": 0, "last": 0}
    for path, leaf in leaves:
        spec = tuple(jmesh._spec_for_leaf(path, leaf, N))
        want = spec.index(jmesh.ENV_AXIS) if jmesh.ENV_AXIS in spec else None
        keys = tuple(k.key for k in path)
        got = pmesh.leaf_axis(keys, torch.from_numpy(np.array(leaf)), N)
        assert got == want, keys
        sub, full = split, tree
        for k in keys:
            sub, full = sub[k], full[k]
        expect = full if got is None else full.narrow(got, 8, 8)
        assert torch.equal(sub, expect), keys
        seen["none" if got is None else "first" if got == 0
             else "last"] += 1
    assert all(seen.values()), seen
    with pytest.raises(ValueError):
        pmesh.make_shard(N, 3, 0)
    with pytest.raises(ValueError):
        pmesh.make_shard(24, 4, 0)           # 6 envs a rank


def test_shuffle_layout_over_ranks():
    """Under auto S is the rank count; a stratum count the ranks do not
    divide raises (each rank holds whole strata); a shrink warns."""
    auto = AlgorithmCfg(num_mini_batches=4, shuffle_strata=0)
    assert tppo.shuffle_layout(auto, T, N, 2)[0] == 2
    assert tppo.shuffle_layout(auto, T, N, 1)[0] == 1
    with pytest.raises(ValueError, match="whole strata"):
        tppo.shuffle_layout(dataclasses.replace(auto, shuffle_strata=1),
                            T, N, 2)
    with pytest.warns(UserWarning, match="in place of 8"):
        S = tppo.shuffle_layout(dataclasses.replace(auto, shuffle_strata=8),
                                3, 8, 1)[0]
    assert S < 8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tppo.shuffle_layout(dataclasses.replace(
            auto, shuffle_strata=4), T, N, 2)[0] == 4


def test_noise_rows_at_an_offset_are_the_full_draws_rows():
    """K8's plain version at element offset r*D (D = 20, 17, 693) and K7's
    at row0 = r (53-dim obs and 693 heights) equal rows [r, r + n) of the
    full draw, bit for bit; offset 0 is the draw of before."""
    seed = torch.tensor([11, 22])
    for D in (20, 17, 693):
        full = cuda_rng.uniform_pm1(seed, (N, D), 1)
        for r in range(N):
            n = N - r
            got = cuda_rng.uniform_pm1(seed, (n, D), 1, r * D)
            assert torch.equal(got, full[r:]), (D, r)
    assert torch.equal(cuda_rng.uniform_pm1(seed, (N, 17), 1, 0),
                       cuda_rng.uniform_pm1_plain(seed, (N, 17), 1))
    from deep_tracking_control_tpu_torch.tasks import registry
    task = tiny_cfgs(registry)[0]
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    args = [task, True, rnd(N, 3), rnd(N, 3), rnd(N, 4), rnd(12, N),
            rnd(12, N), rnd(N, 12), rnd(N, 8), rnd(N), rnd(N, 693),
            rnd(N, 3), rnd(N), rnd(N, 265), rnd(53).abs(), rnd(12), rnd(3),
            seed]
    whole = cuda_obs.compute_observations_fused(*args)
    for r in (4, 8, 3):
        cut = [a[r:] if i in (2, 3, 4, 7, 8, 9, 10, 11, 12, 13)
               else a[:, r:] if i in (5, 6) else a
               for i, a in enumerate(args)]
        for a, b in zip(cuda_obs.compute_observations_fused(*cut, row0=r),
                        whole):
            assert torch.equal(a, b[r:]), r


# ---------------------------------------------------------------------------
# job A: against JAX on a 2-device mesh
# ---------------------------------------------------------------------------
def _gate_state(jenv, state, scale_dt):
    """The JAX init state at the curriculum's gate: the step's common_step
    is a multiple of the episode length, envs 1 and 2 (rank 0) and 9
    (rank 1) time out, rank 0's with tracking sums well over the widening
    threshold and rank 1's at zero: the global mean passes, rank 1's own
    would not."""
    s = dict(_np(state))
    L = jenv.max_episode_length
    s["common_step"] = np.asarray(L - 1, np.int32)
    length = np.array(s["episode_length"])
    length[[1, 2, 9]] = L
    s["episode_length"] = length
    row = jenv.episode_sum_names.index("tracking_lin_vel")
    sums = np.array(s["episode_sums"])
    sums[row, [1, 2]] = 3.0 * 0.8 * scale_dt * L
    sums[row, 9] = 0.0
    s["episode_sums"] = sums
    return s


def _jax_step_draws(jenv, key):
    """The lag indices and the privileged height noise of JAX's step on
    this path, from its key chain (legged_env.py:388, 537, 890, 1172)."""
    import jax
    k_lag, k_post = jax.random.split(key)
    lag = jax.random.randint(k_lag, (jenv.cfg.control.decimation,), 1, 5)
    k_obs = jax.random.split(k_post, 8)[4]
    noise = jax.random.uniform(jax.random.split(k_obs)[0],
                               (N, jenv.num_height_points), minval=-1.0,
                               maxval=1.0)
    return (torch.from_numpy(np.asarray(lag).astype(np.int64)),
            torch.from_numpy(np.array(noise)))


def _update_case(strata, rng_seed=0):
    """A tiny decoder with trained-scale weights, a (T, N) batch, the JAX
    update's draws for two keys and its first updates (fresh states at
    SMALL_LR, and at the default rate), as tests/test_torch_update.py
    makes them."""
    import jax
    import jax.numpy as jnp
    from deep_tracking_control_tpu.agent import ppo as jppo
    from deep_tracking_control_tpu.models import networks as jnet
    rng = np.random.default_rng(rng_seed)
    jm = jnet.ActorCriticDecoder(**NET)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 53)),
                              jnp.zeros((1, 265)), jnp.zeros((1, 1389)),
                              jnp.zeros((1, 3)), jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "Dense_0" not in jax.tree_util.keystr(p)
        and "kernel" in jax.tree_util.keystr(p) else v, params)
    f = np.float32
    mu = rng.normal(0, 0.3, (T, N, 12)).astype(f)
    sigma = rng.uniform(0.8, 1.2, (T, N, 12)).astype(f)
    batch = dict(
        obs=rng.normal(size=(T, N, 53)).astype(f),
        next_obs=rng.normal(size=(T, N, 53)).astype(f),
        privileged_obs=rng.normal(size=(T, N, 1389)).astype(f),
        obs_history=rng.normal(size=(T, N, 265)).astype(f),
        base_vel=rng.normal(size=(T, N, 3)).astype(f),
        actions=(mu + sigma * rng.normal(size=(T, N, 12))).astype(f),
        old_mu=mu, old_sigma=sigma,
        values=rng.normal(size=(T, N)).astype(f),
        returns=rng.normal(size=(T, N)).astype(f),
        advantages=rng.normal(size=(T, N)).astype(f),
        old_log_prob=rng.normal(-15, 1, (T, N)).astype(f))
    bf = ("privileged_obs", "obs_history")
    jbatch = {k: jnp.asarray(v, jnp.bfloat16 if k in bf else jnp.float32)
              for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if k in bf else torch.float32)
        for k, v in jbatch.items()}
    alg = update_alg(strata)
    return jm, params, jbatch, tbatch, alg


def _decoder_draws(alg, key):
    """The decoder update's group permutations and latents from its key
    (agent/ppo.py of the JAX package), at the global N."""
    import jax
    import jax.numpy as jnp
    S, rows_s, _, G = tppo.shuffle_layout(alg, T, N)
    k_perm, k_upd = jax.random.split(key)
    perm = jax.vmap(lambda k: jax.random.permutation(k, rows_s // G))(
        jax.random.split(k_perm, S))
    steps = alg.num_learning_epochs * alg.num_mini_batches
    mb = T * N // alg.num_mini_batches
    eps = np.stack([np.stack([np.asarray(jax.random.normal(k, (mb, 16),
                                                           jnp.float32))
                              for k in jax.random.split(ks)])
                    for ks in jax.random.split(k_upd, steps)])
    return (torch.from_numpy(np.asarray(perm).astype(np.int64)),
            torch.from_numpy(eps))


def _recurrent_batch(rng):
    """A (T, N) batch of the small GRU (obs 10, 4 actions, carries of 16),
    as tests/test_torch_policies.py makes it."""
    f = np.float32
    mu = rng.normal(0, 0.3, (T, N, 4)).astype(f)
    sigma = rng.uniform(0.8, 1.2, (T, N, 4)).astype(f)
    return dict(obs=rng.normal(size=(T, N, 10)).astype(f),
                actions=(mu + sigma * rng.normal(size=(T, N, 4))).astype(f),
                old_mu=mu, old_sigma=sigma,
                values=rng.normal(size=(T, N)).astype(f),
                returns=rng.normal(size=(T, N)).astype(f),
                advantages=rng.normal(size=(T, N)).astype(f),
                old_log_prob=rng.normal(-5, 1, (T, N)).astype(f),
                dones=rng.random((T, N)) < 0.2,
                init_carry_a=rng.normal(0, 0.3, (N, 16)).astype(f),
                init_carry_c=rng.normal(0, 0.3, (N, 16)).astype(f))


def _recurrent_draws(alg, key):
    import jax
    k_perm, _ = jax.random.split(key)
    nmb = alg.num_mini_batches
    return torch.from_numpy(np.concatenate([
        np.asarray(jax.random.permutation(k, N))[:nmb * (N // nmb)]
        .reshape(nmb, N // nmb)
        for k in jax.random.split(k_perm, alg.num_learning_epochs)]))


def _on_mesh(mesh, tree, spec):
    import jax
    from jax.sharding import NamedSharding
    return jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, spec)),
                        tree)


def _jax_decoder_first(mesh, strata, k1, k2):
    """The JAX decoder update at `strata` on the mesh: its first update
    from fresh states (the second update's inputs) and the ranks' inputs;
    returns (inputs, the pieces of the references)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deep_tracking_control_tpu.agent import ppo as jppo
    from deep_tracking_control_tpu.parallel import mesh as jmesh
    from deep_tracking_control_tpu_torch.convert import (opt_state_from_optax,
                                                         params_from_flax)
    jm, params, jbatch, tbatch, alg = _update_case(strata)
    ppo = jppo.PPO(net=jm, alg=alg)
    main_opt, vae_opt = jppo.make_optimizers(alg)
    upd = jax.jit(ppo.update)
    jb = _on_mesh(mesh, jbatch, P(None, jmesh.ENV_AXIS))

    def fresh(lr):        # every argument replicated on the mesh: one compile
        return _on_mesh(mesh, (params, main_opt.init(params),
                               vae_opt.init(params), jnp.asarray(lr)), P())
    p1, s1, v1, lr1, _ = _on_mesh(mesh, upd(*fresh(alg.learning_rate), jb,
                                            k1), P())
    perm1, eps1 = _decoder_draws(alg, k1)
    perm2, eps2 = _decoder_draws(alg, k2)
    inputs = dict(params=params_from_flax(_np(params)), batch=tbatch,
                  perm1=perm1, eps1=eps1, perm2=perm2, eps2=eps2,
                  p1=params_from_flax(_np(p1)),
                  states1=opt_state_from_optax(_np(s1), _np(v1), lr1))

    def refs():
        *_, st1 = upd(*fresh(SMALL_LR), jb, k1)
        p2, _, _, lr2, st2 = upd(p1, s1, v1, lr1, jb, k2)
        return dict(st1=_np(st1), st2=_np(st2), p1=params_from_flax(_np(p1)),
                    p2=params_from_flax(_np(p2)), lr2=float(lr2))
    return inputs, refs


def _jax_recurrent_first(mesh, k1, k2):
    """The same for update_recurrent of a small GRU."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deep_tracking_control_tpu.agent import ppo as jppo
    from deep_tracking_control_tpu.parallel import mesh as jmesh
    from deep_tracking_control_tpu_torch.convert import (opt_state_from_optax,
                                                         params_from_flax)
    from tests.test_torch_policies import _small_recurrent
    jr, rparams, _ = _small_recurrent("gru")
    alg = recurrent_alg()
    jp = jppo.PPO(net=jr, alg=alg, policy_kind="recurrent")
    main_opt, _ = jppo.make_optimizers(alg)
    batch = _recurrent_batch(np.random.default_rng(5))
    rb = {k: _on_mesh(mesh, jnp.asarray(v), P(jmesh.ENV_AXIS)
                      if k.startswith("init_carry")
                      else P(None, jmesh.ENV_AXIS)) for k, v in batch.items()}
    upd = jax.jit(jp.update_recurrent)

    def fresh(lr):
        return _on_mesh(mesh, (rparams, main_opt.init(rparams),
                               jnp.asarray(lr)), P())
    q1, s1, lr1, _ = _on_mesh(mesh, upd(*fresh(alg.learning_rate), rb, k1),
                              P())
    inputs = dict(params=params_from_flax(_np(rparams)),
                  batch={k: torch.from_numpy(np.asarray(v))
                         for k, v in batch.items()},
                  idx1=_recurrent_draws(alg, k1),
                  idx2=_recurrent_draws(alg, k2),
                  p1=params_from_flax(_np(q1)),
                  states1=opt_state_from_optax(_np(s1), None, lr1))

    def refs():
        *_, st1 = upd(*fresh(SMALL_LR), rb, k1)
        q2, _, lr2, st2 = upd(q1, s1, lr1, rb, k2)
        return dict(st1=_np(st1), st2=_np(st2), p1=params_from_flax(_np(q1)),
                    p2=params_from_flax(_np(q2)), lr2=float(lr2))
    return inputs, refs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs, run at once.  Job B starts first (after the W=1 run that
    writes its checkpoint); job A's ranks start once the JAX first updates
    (their inputs) are made, in threads; the JAX references, the port's
    unsharded step and the W=1 run that goes on are computed while the
    ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deep_tracking_control_tpu.env.legged_env import LeggedEnv as JEnv
    from deep_tracking_control_tpu.models import networks as jnet
    from deep_tracking_control_tpu.parallel import mesh as jmesh
    from deep_tracking_control_tpu.tasks import registry as jreg
    from deep_tracking_control_tpu_torch.convert import (env_from_jax,
                                                         params_from_flax)
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.tasks import registry as treg
    root_a = tmp_path_factory.mktemp("job_a")
    root_b = tmp_path_factory.mktemp("job_b")
    running = []
    try:
        # job B: the W=1 run writes the checkpoint that the ranks load
        w1 = runner(None, 2)
        first = w1.learn(1)
        w1.save(str(root_b / "w1.pt"))
        running.append(start_job("b", root_b))

        mesh = jmesh.make_mesh(jax.devices()[:W])
        k1, k2 = jax.random.PRNGKey(2), jax.random.PRNGKey(3)
        pool = ThreadPoolExecutor(3)
        firsts = {S: pool.submit(_jax_decoder_first, mesh, S, k1, k2)
                  for S in STRATA}
        firsts["recurrent"] = pool.submit(
            _jax_recurrent_first, mesh, k1,
            jax.random.PRNGKey(EMPTY_SPLIT_KEY))
        inputs = {}
        with pytest.MonkeyPatch.context() as mp:
            # JAX's CPU route (no Pallas kernel) is the port's physics-off
            mp.setenv("DTC_PALLAS_PHYSICS", "0")
            jenv = JEnv(tiny_cfgs(jreg, quiet=True)[0])
            jparams, jstate0 = jenv.init(jax.random.PRNGKey(0))
        jstate = _gate_state(jenv, jstate0,
                             jenv.reward_scales_dt["tracking_lin_vel"])
        actions = (0.3 * np.random.default_rng(0).normal(size=(N, 12))
                   ).astype(np.float32)
        key = jax.random.PRNGKey(100)
        lag, noise = _jax_step_draws(jenv, key)
        inputs["env"] = dict(
            params=_np(jparams), state=jstate,
            grid_height=np.asarray(jenv.grid.height),
            terrain_origins=np.asarray(jenv.terrain_origins),
            actions=torch.from_numpy(actions), lag=lag, height_noise=noise,
            seed=5)

        def jax_step():
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("DTC_PALLAS_PHYSICS", "0")
                js = jax.tree.map(jnp.asarray, jstate)
                sh_s = jmesh.tree_shardings(mesh, js, N)
                sh_p = jmesh.tree_shardings(mesh, jparams, N)
                s, o = jax.jit(jenv.step)(jmesh.apply_shardings(jparams, sh_p),
                                          jmesh.apply_shardings(js, sh_s),
                                          jnp.asarray(actions), key)
                return dict(state=_np(s), out=_np(o))
        step_ref = pool.submit(jax_step)

        # (b) the CE-net: rank 1's rows 9-15 are rank 0's rows 1-7 (ties
        # across the ranks, the median's among them), rank 0's row 0 is far
        # out (outliers on one rank) and rank 1's row 8 its own: each
        # rank's own statistics differ from the global ones
        rng = np.random.default_rng(1)
        cm = jnet.ActorCriticDecoder(**NET)
        cparams = cm.init(jax.random.PRNGKey(4), jnp.zeros((1, 53)),
                          jnp.zeros((1, 265)), jnp.zeros((1, 1389)),
                          jnp.zeros((1, 3)), jax.random.PRNGKey(1))
        hist = rng.normal(size=(N, 265)).astype(np.float32)
        hist[0] *= 40.0
        hist[9:] = hist[1:8]
        w_lv = rng.normal(size=(N, 16)).astype(np.float32)
        w_mu = rng.normal(size=(N, 19)).astype(np.float32)
        inputs["cenet"] = dict(params=params_from_flax(_np(cparams)),
                               hist=torch.from_numpy(hist),
                               w_lv=torch.from_numpy(w_lv),
                               w_mu=torch.from_numpy(w_mu))

        def cenet_ref():
            jh = _on_mesh(mesh, jnp.asarray(hist), P(jmesh.ENV_AXIS))

            def f(p):
                mu, lv = cm.apply(p, jh,
                                  method=lambda m, h: m.vae.cenet_stats(h))
                return jnp.sum(w_lv * lv) + jnp.sum(w_mu * mu), (mu, lv)
            g, (mu, lv) = jax.grad(f, has_aux=True)(cparams)
            return dict(logvar=np.asarray(lv), mu=np.asarray(mu),
                        grads=params_from_flax(_np(g)))
        cenet = pool.submit(cenet_ref)

        refs = {}
        inputs["update"] = {}
        for S in STRATA:
            inputs["update"][S], refs[f"update{S}"] = firsts[S].result()
        inputs["recurrent"], refs["recurrent"] = firsts["recurrent"].result()
        torch.save(inputs, root_a / "inputs.pt")
        running.append(start_job("a", root_a, {"DTC_PALLAS_PHYSICS": "0"}))

        ref = {k: f() for k, f in refs.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DTC_PALLAS_PHYSICS", "0")
            tenv = LeggedEnv(tiny_cfgs(treg, quiet=True)[0], device="cpu")
            tp, ts = env_from_jax(inputs["env"]["params"], jstate,
                                  inputs["env"]["grid_height"], tenv,
                                  inputs["env"]["terrain_origins"])
            ts, to = tenv.step(tp, ts, torch.from_numpy(actions),
                               torch.Generator().manual_seed(5),
                               draws=dict(lag=lag, height_noise=noise))
        ref["tstep"] = dict(state=ts, out=to)
        resumed = w1.learn(1)
        ref["jstep"] = step_ref.result()
        ref["cenet"] = cenet.result()
        pool.shutdown()
    except BaseException:
        for procs in running:
            for p, _ in procs:
                p.kill()
        raise
    ranks_b = finish_job(running[0], root_b)
    ranks_a = finish_job(running[1], root_a)
    loaded = runner(None, 2)
    loaded.load(str(root_b / "w2.pt"))
    return dict(a=dict(ref=ref, ranks=ranks_a, inputs=inputs),
                b=dict(root=root_b, first=first, resumed=resumed,
                       ranks=ranks_b, loaded=state_of(loaded)))


@pytest.fixture(scope="module")
def job_a_run(jobs):
    return jobs["a"]


@pytest.fixture(scope="module")
def job_b_run(jobs):
    return jobs["b"]


def _step_field(ranks, *keys, axis=0):
    parts = []
    for r in ranks:
        x = r["step"]
        for k in keys:
            x = x[k]
        parts.append(x)
    return torch.cat(parts, axis)


def test_sharded_step_matches_jax_and_unsharded(job_a_run):
    """(a) One step at the curriculum's gate with resets on both ranks."""
    ranks, ref = job_a_run["ranks"], job_a_run["ref"]
    jo, js = ref["jstep"]["out"], ref["jstep"]["state"]
    done = _step_field(ranks, "out", "done").numpy()
    np.testing.assert_array_equal(done, jo["done"])
    assert done[[1, 2, 9]].all() and not done.all()
    keep = ~done
    # the widened command range, from the counts over both ranks
    start = np.asarray(job_a_run["inputs"]["env"]["state"]
                       ["command_lin_vel_x"])
    for r in ranks:
        got = r["step"]["state"]["command_lin_vel_x"].numpy()
        np.testing.assert_array_equal(got, js["command_lin_vel_x"])
        assert not np.array_equal(got, start)
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        got = _step_field(ranks, "state", "phys", k, axis=1).numpy()
        np.testing.assert_allclose(got[:, keep], js["phys"][k][:, keep],
                                   **PHYS, err_msg=k)
    for k in ("obs", "privileged_obs", "obs_history", "base_vel"):
        got = _step_field(ranks, "out", k).numpy()
        np.testing.assert_allclose(got[keep], jo[k][keep], **OBS, err_msg=k)
    np.testing.assert_allclose(_step_field(ranks, "out", "rew").numpy(),
                               jo["rew"], **OBS)
    np.testing.assert_allclose(
        _step_field(ranks, "state", "episode_sums", axis=1).numpy(),
        js["episode_sums"], **OBS)
    for k, v in jo["metrics"].items():
        got = sum(float(r["step"]["out"]["metrics"][k]) for r in ranks)
        np.testing.assert_allclose(got, float(v), **OBS, err_msg=k)
    # against the unsharded port step from the same generator seed: the
    # same draws (every row of them) and the same per-env arithmetic
    ts, to = ref["tstep"]["state"], ref["tstep"]["out"]
    for k, v in ts.items():
        if k == "phys":
            for p, x in v.items():
                torch.testing.assert_close(
                    _step_field(ranks, "state", "phys", p, axis=1), x,
                    rtol=0, atol=0)
        elif k in ("command_lin_vel_x", "common_step"):
            assert torch.equal(ranks[1]["step"]["state"][k], v), k
        else:
            axis = pmesh.leaf_axis((k,), v, N)
            torch.testing.assert_close(
                _step_field(ranks, "state", k, axis=axis), v, rtol=0, atol=0,
                msg=k)


def test_sharded_cenet_stats_and_gradients_match_jax(job_a_run):
    """(b) The filtered logvar of both ranks and the sum of their
    gradients against JAX on the global batch (outliers in rank 0's row 0,
    the median tied across the ranks)."""
    from deep_tracking_control_tpu_torch.models import networks as tnet
    ranks, want = job_a_run["ranks"], job_a_run["ref"]["cenet"]
    c = job_a_run["inputs"]["cenet"]
    lv = torch.cat([r["cenet"]["logvar"] for r in ranks])
    assert torch.equal(lv[1:8], lv[9:])               # ties across ranks
    err = float((lv - torch.tensor(want["logvar"])).abs().max())
    assert err <= 0.02 * np.abs(want["logvar"]).max() + 1e-6, err
    # the outliers took one value: the median of the others over both
    # ranks' rows, which the unsharded filter picks too
    net = tnet.ActorCriticDecoder(**NET)
    net.load_state_dict(c["params"])
    with torch.no_grad():
        raw = net.vae.latent_var(net.vae.cenet_encoder(c["hist"]))
        _, whole = net.vae.cenet_stats(c["hist"])
    replaced = lv != raw
    assert replaced[0].any() and not replaced[8:].any()
    center = torch.unique(lv[replaced])
    assert len(center) == 1
    # the median the outliers took is a value of both ranks' rows
    assert (raw[:8] == center).any() and (raw[8:] == center).any()
    assert torch.equal(lv, whole)
    for name in ranks[0]["cenet"]["grads"]:
        got = sum(r["cenet"]["grads"][name] for r in ranks).double().reshape(-1)
        g = want["grads"][name].double().reshape(-1)
        if float(g.norm()) > 0:
            cos = float(got @ g / (got.norm() * g.norm()))
            assert cos >= 0.999, (name, cos)


@pytest.mark.parametrize("strata", STRATA)
def test_sharded_decoder_update_matches_jax(job_a_run, strata):
    """(c) The fused decoder update, each rank on its strata: the stats of
    an update from fresh states at SMALL_LR, then a second update from
    the JAX state after one."""
    ranks, want = job_a_run["ranks"], job_a_run["ref"][f"update{strata}"]
    _check_update(ranks, want, f"update{strata}")


def test_sharded_update_recurrent_matches_jax(job_a_run):
    """(d) A small GRU's update_recurrent: each rank replays the envs of
    each minibatch that it holds (any number of them): uneven splits in
    the first update, and in the second minibatches that one rank holds
    none of."""
    ranks, want = job_a_run["ranks"], job_a_run["ref"]["recurrent"]
    rec = job_a_run["inputs"]["recurrent"]
    counts = {int((row < N // 2).sum()) for row in rec["idx1"]}
    assert len(counts) > 1, counts              # uneven splits happen
    counts = [int((row < N // 2).sum()) for row in rec["idx2"]]
    assert 0 in counts and N // 2 in counts, counts     # empty on each rank
    _check_update(ranks, want, "recurrent")


def _check_update(ranks, want, key):
    for r in ranks:
        for k in tppo.STAT_NAMES:
            np.testing.assert_allclose(float(r[key]["st1"][k]),
                                       float(want["st1"][k]), rtol=1e-3,
                                       atol=1e-6, err_msg=f"first {k}")
            np.testing.assert_allclose(float(r[key]["st2"][k]),
                                       float(want["st2"][k]), rtol=5e-3,
                                       atol=1e-6, err_msg=f"second {k}")
        np.testing.assert_allclose(float(r[key]["lr"]), want["lr2"],
                                   rtol=1e-6)
    names = list(ranks[0][key]["params"])
    for n in names:
        assert torch.equal(ranks[0][key]["params"][n],
                           ranks[1][key]["params"][n]), n
    p1, p2, got = (torch.cat([d[n].reshape(-1) for n in names]) for d in (
        want["p1"], want["p2"], ranks[0][key]["params"]))
    d_jax, d_port = p2 - p1, got - p1
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm()) <= 5e-2 * float(d_jax.norm())


# ---------------------------------------------------------------------------
# job B: port against port
# ---------------------------------------------------------------------------
def _close_stats(got, want):
    for k in SHARD_STATS:
        np.testing.assert_allclose(got[k], want[k], **MULTICHIP, err_msg=k)


def test_sharded_learn_matches_unsharded(job_b_run):
    """learn(2) at W=2 against W=1 at shuffle_strata 2: iteration-1 stats
    within the JAX package's sharded-training budget; the params and the
    generator equal on both ranks, bit for bit."""
    ranks = job_b_run["ranks"]
    _close_stats(ranks[0]["rows"][0], job_b_run["first"][0])
    a, b = ranks[0]["trained"], ranks[1]["trained"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    for r in ranks:
        row = r["rows"][1]
        assert all(np.isfinite(v) for k, v in row.items() if k != "trace")


def test_checkpoints_cross_world_sizes(job_b_run):
    """Saved at W=1, loaded at W=2: the next iteration matches the W=1 run
    that went on.  Saved at W=2 (rank 0 writes the gathered state),
    loaded at W=1: the optimizer and generator states, the iteration and
    the env state are the ranks'."""
    ranks, loaded = job_b_run["ranks"], job_b_run["loaded"]
    _close_stats(ranks[0]["resumed"][0], job_b_run["resumed"][0])
    saved = ranks[0]["saved"]
    assert loaded["iter"] == saved["iter"] == 2
    assert torch.equal(loaded["generator"], saved["generator"])
    assert torch.equal(loaded["lr"], saved["lr"])
    for opt in ("opt", "vae_opt"):
        assert torch.equal(loaded[opt]["count"], saved[opt]["count"])
        for m in ("mu", "nu"):
            for k, v in saved[opt][m].items():
                assert torch.equal(loaded[opt][m][k], v), (opt, m, k)
    for k, v in loaded["env_state"].items():
        if k == "phys":
            for p, x in v.items():
                parts = [r["saved"]["env_state"]["phys"][p] for r in ranks]
                assert torch.equal(x, torch.cat(parts, 1)), p
            continue
        axis = pmesh.leaf_axis((k,), v, N)
        want = (ranks[0]["saved"]["env_state"][k] if axis is None else
                torch.cat([r["saved"]["env_state"][k] for r in ranks], axis))
        assert torch.equal(v, want), k


def test_train_script_under_the_ranks_environment(job_b_run, monkeypatch):
    """scripts.train with WORLD_SIZE/RANK set joins the group, trains
    N / W envs a rank and writes one run directory from rank 0.  Without
    a card, a launch that leaves --device at cuda stops before it joins
    a group (it does not carry on on the CPU)."""
    from deep_tracking_control_tpu_torch.scripts import train as script
    from deep_tracking_control_tpu_torch.tasks import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(script, "get_cfgs", lambda name: tiny_cfgs(registry))
    for k, v in dict(WORLD_SIZE=str(W), RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--task", "lite3_dtc", "--num_envs", str(N),
                     "--log_root", str(job_b_run["root"] / "nocard")])
    assert not torch.distributed.is_initialized()
    ranks = job_b_run["ranks"]
    dirs = {r["script"]["log_dir"] for r in ranks}
    assert len(dirs) == 1
    for r in ranks:
        assert r["script"]["n_local"] == N // W and r["script"]["iter"] == 1
    runs = list((job_b_run["root"] / "logs").glob("*/*"))
    assert [str(p) for p in runs] == list(dirs)
    models = sorted(p.name for p in runs[0].glob("model_*.pt"))
    assert models == ["model_0.pt", "model_1.pt"]


def test_a_failing_rank_ends_the_job(tmp_path):
    """Rank 1 raises while rank 0 waits for it at a collective: both end,
    and the failure carries rank 1's output."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        finish_job(start_job("fail", tmp_path), tmp_path, timeout=120)
    assert time.monotonic() - t0 < 120


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
