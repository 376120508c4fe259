"""The env step as a CUDA graph (env/step_graph.py): where it engages, and
on the card that a graphed collect equals the eager one bit for bit.

On the CPU (no JAX): a 16-env learn(1) steps eagerly and the tracer's
"graphs" counter reads no capture and no replay; the graph route's
conditions (`LeggedEnv._graph_route`) one by one, on a CPU env seen as on
the card.  Marked `cuda` (skip without a GPU; run on a machine with a card
with `python -m pytest --noconftest tests/test_torch_step_graph.py -q`):
at 512 envs of lite3_dtc and x30_dtc, two collects with the episode
lengths desynchronized (resets) and a push window inside the first, the
graphed collect against the same collect with every step eager: every
batch field, the env state and the generator's state after each collect
exactly; a batch unchanged by the next collect; the graph counter (one
capture, then 24 replays a collect) and K1's launches.  The same for a GRU
policy's collect, and a step with injected draws or on a sharded env
inside the scope runs eagerly.
"""
import contextlib
import dataclasses

import pytest
import torch

from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.parallel.mesh import make_shard
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.tasks import registry
from deep_tracking_control_tpu_torch.utils import trace

N, T = 16, 4


def _small(task, n):
    return dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=n),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))


def _cpu_runner():
    task, train = registry.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        _small(task, N),
        control=dataclasses.replace(task.control, decimation=2))
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(train.policy, terrain_latent=32,
                                   actor_hidden_dims=(32,),
                                   critic_hidden_dims=(32,)),
        algorithm=dataclasses.replace(train.algorithm, num_learning_epochs=1,
                                      num_mini_batches=4),
        runner=dataclasses.replace(train.runner, num_steps_per_env=T))
    return OnPolicyRunner(LeggedEnv(task, device="cpu"), train)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cpu_learn_steps_eagerly(monkeypatch, one_thread):
    """A learn iteration on the CPU: every step eager, no graph held."""
    monkeypatch.setattr(trace, "enabled", True)
    runner = _cpu_runner()
    (row,) = runner.learn(1)
    assert row["trace"]["graphs"] == {
        "env.step": dict(captures=0, replays=0, eager=T)}
    assert runner.env._step_graphs == {}


def _buffered(step):
    """`step` as a graph replays it: each call's outputs written into the
    same tensors, returned in new dicts."""
    bufs = {}

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return bufs[path]

    def inner(*args, **kwargs):
        result = dict(zip(("state", "out"), step(*args, **kwargs)))
        new = [(p, t.clone()) for p, t in leaves(result)]
        for p, t in new:
            if p in bufs:
                bufs[p].copy_(t)
            else:
                bufs[p] = t
        return build(result["state"], ("state",)), build(result["out"],
                                                          ("out",))
    return inner


def test_collect_copies_what_it_keeps(one_thread):
    """A collect whose steps return the same tensors every step, as a
    graph's replays do, gathers the batch and sums of a plain collect."""
    plain, buffered = _cpu_runner(), _cpu_runner()
    buffered.env.step = _buffered(buffered.env.step)
    for _ in range(2):
        want, want_aux = plain.collect()
        got, got_aux = buffered.collect()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for k in want_aux:
            assert torch.equal(torch.as_tensor(got_aux[k]),
                               torch.as_tensor(want_aux[k])), k


@pytest.fixture(scope="module")
def envs():
    """A 16-env lite3_dtc on the CPU, and the same env as the block of a
    one-rank shard."""
    task, _ = registry.get_cfgs("lite3_dtc")
    task = _small(task, N)
    return (LeggedEnv(task, device="cpu"),
            LeggedEnv(task, device="cpu", shard=make_shard(N, 1, 0)))


@pytest.mark.parametrize("case", ["graphed", "outside", "draws", "sharded",
                                  "sampler_off", "strict"])
def test_graph_route(envs, monkeypatch, case):
    """The route's conditions one at a time, the env seen as on the card:
    only inside `graphed_steps`, without draws, unsharded, on the default
    kernel route."""
    env = envs[1] if case == "sharded" else envs[0]
    monkeypatch.setattr(env, "device", torch.device("cuda"))
    if case == "sampler_off":
        monkeypatch.setenv("DTC_PALLAS_SAMPLER", "0")
    if case == "strict":
        monkeypatch.setenv("DTC_STRICT_PARITY", "1")
    draws = {"noise_seed": torch.zeros(2, dtype=torch.int64)} \
        if case == "draws" else None
    scope = (contextlib.nullcontext() if case == "outside"
             else env.graphed_steps())
    with scope:
        assert env._graph_route(draws) == (case == "graphed")
    assert not env._graph_route(None)


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_tracking_control_tpu_torch import cuda_build
    cuda_build.build()
    return torch.device("cuda")


def _card_runner(task_name, n, graphed, policy=None):
    """A runner at n envs on the card; graphed=False steps eagerly (its
    env's `graphed_steps` scope does nothing)."""
    task, train = registry.get_cfgs(task_name)
    task = dataclasses.replace(task,
                               env=dataclasses.replace(task.env, num_envs=n))
    if policy is not None:
        train = dataclasses.replace(train, policy=dataclasses.replace(
            train.policy, policy_class_name="ActorCriticRecurrent",
            rnn_type=policy))
    env = LeggedEnv(task, device="cuda")
    if not graphed:
        env.graphed_steps = contextlib.nullcontext
    runner = OnPolicyRunner(env, train)
    # desynchronized episodes (learn's init_at_random_ep_len), and a push
    # window a few steps into the first collect's replays
    st = runner.env_state
    st["episode_length"] = torch.randint(
        0, env.max_episode_length, (n,), generator=runner.generator,
        device="cuda", dtype=torch.int32)
    if task.domain_rand.push_robots:
        st["common_step"] = torch.full_like(st["common_step"],
                                            task.push_interval - 10)
    return runner


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return tree.detach().cpu().clone()


def _equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), where


def _collects(runner, n=2):
    """n collects: per collect (batch, env state, generator state, tracer
    row, resets) on the host, and the first batch as the card holds it."""
    out, first = [], None
    for _ in range(n):
        trace.begin(0)
        batch, aux = runner.collect()
        tr = trace.end()
        torch.cuda.synchronize()
        first = batch if first is None else first
        out.append((_host(batch), _host(runner.env_state),
                    runner.generator.get_state().clone(), tr,
                    float(aux["metric_n_done"])))
    return out, first


@pytest.mark.cuda
@pytest.mark.parametrize("task_name", ["lite3_dtc", "x30_dtc"])
def test_graphed_collect_equals_eager(card, task_name, monkeypatch):
    monkeypatch.setattr(trace, "enabled", True)
    n = 512
    graphed, first = _collects(_card_runner(task_name, n, True))
    eager, _ = _collects(_card_runner(task_name, n, False))
    T = len(graphed[0][0]["obs"])
    for i, (g, e) in enumerate(zip(graphed, eager)):
        _equal(g[0], e[0], f"collect {i} batch")
        _equal(g[1], e[1], f"collect {i} env state")
        assert torch.equal(g[2], e[2]), f"collect {i} generator"
        assert e[3]["graphs"]["env.step"] == dict(captures=0, replays=0,
                                                  eager=T)
        assert g[3]["launches"]["K1"] == e[3]["launches"]["K1"] == T
    assert graphed[0][3]["graphs"]["env.step"] == dict(
        captures=1, replays=T - 2, eager=1)
    assert graphed[1][3]["graphs"]["env.step"] == dict(
        captures=0, replays=T, eager=0)
    # the first batch holds no graph buffer: the second collect left it
    _equal(_host(first), graphed[0][0], "first batch after the second")
    assert graphed[0][4] > 0 and graphed[1][4] > 0      # resets replayed


@pytest.mark.cuda
def test_graphed_recurrent_collect_equals_eager(card, monkeypatch):
    """The GRU policy's collect (its dones stored) graphed and eager."""
    monkeypatch.setattr(trace, "enabled", True)
    graphed, _ = _collects(_card_runner("lite3_dtc", 512, True, "gru"))
    eager, _ = _collects(_card_runner("lite3_dtc", 512, False, "gru"))
    for i, (g, e) in enumerate(zip(graphed, eager)):
        _equal(g[0], e[0], f"collect {i} batch")
        _equal(g[1], e[1], f"collect {i} env state")
        assert torch.equal(g[2], e[2]), f"collect {i} generator"
    assert int(graphed[0][0]["dones"][2:].sum()) > 0
    assert graphed[1][3]["graphs"]["env.step"]["replays"] == len(
        graphed[1][0]["obs"])


@pytest.mark.cuda
def test_draws_and_shards_step_eagerly_on_the_card(card, monkeypatch):
    """Inside the scope, steps with injected draws, and steps of a
    one-rank shard's env, run eagerly."""
    monkeypatch.setattr(trace, "enabled", True)
    task, _ = registry.get_cfgs("lite3_dtc")
    task = _small(task, 64)
    for shard in (None, make_shard(64, 1, 0)):
        env = LeggedEnv(task, device="cuda", shard=shard)
        gen = torch.Generator("cuda").manual_seed(3)
        params, state = env.init(gen)
        actions = torch.zeros((64, env.num_actions), device="cuda")
        draws = {"noise_seed": torch.tensor([5, 7], device="cuda")} \
            if shard is None else None
        trace.begin(0)
        with env.graphed_steps():
            for _ in range(3):
                state, _ = env.step(params, state, actions, gen, draws)
        tr = trace.end()
        assert tr["graphs"]["env.step"] == dict(captures=0, replays=0,
                                                eager=3)
        assert env._step_graphs == {}
