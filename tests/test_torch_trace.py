"""The port's tracer (utils/trace.py): span arithmetic on a fake clock, and
the spans and counters of a 16-env learn iteration on the CPU, in the row
and as torch.profiler user annotations.

A 16-env lite3_dtc on a small terrain (decimation 2, 4 steps an
iteration) with a tiny decoder net and one epoch of 4 minibatches, so a
learn(1) takes about a second.
"""
import ast
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.tasks import registry
from deep_tracking_control_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deep_tracking_control_tpu_torch"
N, T, MB = 16, 4, 4
KERNELS = ("K1", "K1w", "K1f64", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
           "K9")
# each span and its parent, as the default route nests them
PARENT = {"dtc/collect": "dtc/learn", "dtc/update": "dtc/learn",
          "dtc/learn/stats": "dtc/learn", "dtc/sync/stats": "dtc/learn/stats",
          "dtc/env.step": "dtc/collect", "dtc/collect/loop": "dtc/collect",
          "dtc/collect/gae": "dtc/collect",
          "dtc/env.step/terrain": "dtc/env.step",
          "dtc/env.step/physics": "dtc/env.step",
          "dtc/env.step/commands": "dtc/env.step",
          "dtc/env.step/planner": "dtc/env.step",
          "dtc/env.step/rewards": "dtc/env.step",
          "dtc/env.step/reset": "dtc/env.step",
          "dtc/env.step/obs": "dtc/env.step",
          "dtc/update/draw": "dtc/update", "dtc/update/shuffle": "dtc/update",
          "dtc/update/minibatch": "dtc/update",
          "dtc/update/adam": "dtc/update/minibatch"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner():
    task, train = registry.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=N),
        control=dataclasses.replace(task.control, decimation=2),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(train.policy, terrain_latent=32,
                                   actor_hidden_dims=(32,),
                                   critic_hidden_dims=(32,)),
        algorithm=dataclasses.replace(train.algorithm, num_learning_epochs=1,
                                      num_mini_batches=MB),
        runner=dataclasses.replace(train.runner, num_steps_per_env=T))
    return OnPolicyRunner(LeggedEnv(task, device="cpu"), train)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """learn(1) under torch.profiler (CPU): the runner, its row and the
    profiler's user annotations {name: [(start, end)]}."""
    runner = _runner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (row,) = runner.learn(1)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    ann = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return runner, row, ann


@pytest.fixture
def clock(monkeypatch):
    """The tracer on a fake clock: each read returns the next value."""
    times = []
    monkeypatch.setattr(trace, "perf_counter_ns", lambda: times.pop(0))
    monkeypatch.setattr(trace, "enabled", True)
    return times


def ns(spans):
    """{name: (count, host ns, wait ns)}"""
    return {k: (a["count"], round(a["host_s"] * 1e9), round(a["wait_s"] * 1e9))
            for k, a in spans.items()}


def test_nested_spans_host_and_wait(clock):
    """outer [0, 100] holds inner [10, 60], which holds a sync [20, 50];
    a sync [70, 80] and an explicit one [85, 90] sit in outer itself."""
    clock += [0, 10, 20, 50, 60, 70, 80, 85, 90, 100]
    trace.begin(7)
    with trace.span("t/outer"):
        with trace.span("t/inner"):
            with trace.sync("t/sync/a"):
                pass
        with trace.sync("t/sync/b"):
            pass
        with trace.sync("t/sync/clock", explicit=True):
            pass
    out = trace.end()
    s = out["spans"]
    assert out["iteration"] == 7
    assert ns(s) == {"t/outer": (1, 100, 45), "t/inner": (1, 50, 30),
                     "t/sync/a": (1, 30, 30), "t/sync/b": (1, 10, 10),
                     "t/sync/clock": (1, 5, 5)}
    assert (out["syncs"], out["explicit_syncs"]) == (2, 1)
    assert out["launches"] == dict.fromkeys(KERNELS, 0)
    assert trace.end() is None                 # the iteration is closed
    # the next iteration starts from zero
    clock += [0, 5]
    trace.begin(8)
    with trace.span("t/outer"):
        pass
    out = trace.end()
    assert out["iteration"] == 8 and out["syncs"] == 0
    assert ns(out["spans"]) == {"t/outer": (1, 5, 0)}


def test_disabled_tracer_is_a_shared_noop(monkeypatch):
    monkeypatch.setattr(trace, "enabled", False)
    assert trace.span("t/a") is trace.sync("t/b") is trace.span("t/c")
    trace.begin(0)
    with trace.span("t/a"):
        with trace.sync("t/b"):
            pass
    assert trace.end() is None
    assert "t/a" not in trace._spans


def test_row_trace(traced):
    """The row's "trace": one iteration's counts, host and wait times."""
    runner, row, _ = traced
    tr = row["trace"]
    assert set(tr) == {"iteration", "spans", "syncs", "explicit_syncs",
                       "launches", "graphs"}
    assert tr["iteration"] == runner.current_learning_iteration - 1 == 0
    s = tr["spans"]
    want = {"dtc/learn": 1, "dtc/collect": 1, "dtc/update": 1,
            "dtc/env.step": T, "dtc/act": T + 1, "dtc/collect/loop": T,
            "dtc/env.step/terrain": 2 * T, "dtc/update/minibatch": MB,
            "dtc/update/adam": 2 * MB, "dtc/sync/stats": 1}
    assert {k: s[k]["count"] for k in want} == want
    assert set(s) == set(PARENT) | {"dtc/learn", "dtc/act"}
    for a in s.values():
        assert a["host_s"] >= a["wait_s"] >= 0.0
    syncs = [k for k in s if k.startswith("dtc/sync/")]
    assert tr["syncs"] == sum(s[k]["count"] for k in syncs)
    assert tr["explicit_syncs"] == 0     # the CPU's clock waits on nothing
    assert s["dtc/learn"]["wait_s"] == pytest.approx(
        sum(s[k]["wait_s"] for k in syncs), rel=1e-9)
    assert tr["launches"] == dict.fromkeys(KERNELS, 0)   # plain versions
    # the step's constants live on the device: its one sync is the stats'
    assert tr["syncs"] == 1
    assert tr["graphs"] == {"env.step": dict(captures=0, replays=0, eager=T)}


def test_spans_are_user_annotations_inside_their_parents(traced):
    """Under torch.profiler each span is a user annotation of its name,
    as many as the row counts, each inside one of its parent's."""
    _, row, ann = traced
    counts = {k: len(v) for k, v in ann.items() if k.startswith("dtc/")}
    assert counts == {k: a["count"] for k, a in row["trace"]["spans"].items()}
    for child, parent in PARENT.items():
        for s, e in ann[child]:
            assert any(ps <= s and e <= pe for ps, pe in ann[parent]), child


def test_tracing_off_changes_no_stat(traced, monkeypatch):
    """The same learn(1) with tracing off: no "trace", the same stats and
    weights bit for bit."""
    runner, row, _ = traced
    monkeypatch.setattr(trace, "enabled", False)
    other = _runner()
    (plain,) = other.learn(1)
    assert "trace" not in plain
    keys = [k for k in row if k != "trace" and not k.endswith("_time")]
    assert keys and {k: plain[k] for k in keys} == {k: row[k] for k in keys}
    for k, v in runner.net.state_dict().items():
        assert torch.equal(v, other.net.state_dict()[k]), k


def test_no_program_span_is_a_benchmark_range(traced):
    """Every span name in the port begins with dtc/ and none is one of
    the benchmark's ranges (bench_port/harness/program.py RANGES)."""
    tree = ast.parse((ROOT / "bench_port/harness/program.py").read_text())
    ranges = next(ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "RANGES")
    named = set()
    for p in PORT.rglob("*.py"):
        named |= set(re.findall(
            r'trace\.(?:span|sync|spanned)\(\s*"([^"]+)"', p.read_text()))
    assert set(traced[1]["trace"]["spans"]) <= named
    assert all(n.startswith("dtc/") for n in named), named
    assert not named & set(ranges)


def test_log_writes_the_tracer_scalars(traced, capsys):
    runner, row, _ = traced

    class Writer:
        scalars = {}

        def add_scalar(self, k, v, it):
            self.scalars[k] = v
    runner.writer = w = Writer()
    try:
        runner._log(0, row, 1.0)
    finally:
        runner.writer = None
    capsys.readouterr()
    tr = row["trace"]
    assert w.scalars["Perf/syncs"] == tr["syncs"] + tr["explicit_syncs"]
    for k, a in tr["spans"].items():
        assert w.scalars["Perf/host_ms/" + k] == pytest.approx(
            1e3 * a["host_s"])
    assert not any(k.startswith("Perf/launches/") for k in w.scalars)
    assert {k: v for k, v in w.scalars.items()
            if k.startswith("Perf/graphs/")} == {
        "Perf/graphs/env.step/captures": 0,
        "Perf/graphs/env.step/replays": 0, "Perf/graphs/env.step/eager": T}
