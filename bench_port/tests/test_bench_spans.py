"""The readers of the port's own spans and counters (the rows' "trace",
deep_tracking_control_tpu_torch/utils/trace.py) on synthetic rows, and on
the card the tracer's sync count against torch's sync debug mode.

    python -m pytest bench_port/tests/test_bench_spans.py -q
    python -m pytest bench_port/tests/test_bench_spans.py -q -m cuda   (card)
"""
import collections
import os
import warnings

import pytest

from harness import manifest
from harness.main import Run
from harness.trace import Trace

NEW = ("step_host_ms", "act_host_ms", "update_host_ms", "sync_wait_ms",
       "host_syncs", "step_host_us_per_op")


def agg(count, host_s, wait_s=0.0):
    return dict(count=count, host_s=host_s, wait_s=wait_s)


def row(step_host, step_wait, syncs, sync_wait, iteration=0):
    """A row of 2 env steps, 3 acts, one update; `syncs` implicit syncs
    of `sync_wait` s in all (inside the steps) and 2 explicit of 1 ms."""
    return dict(collection_time=0.3, learning_time=0.6, trace=dict(
        iteration=iteration, syncs=syncs, explicit_syncs=2,
        launches={"K1": 2, "K9": 1},
        spans={"dtc/learn": agg(1, 1.0, sync_wait + 0.002),
               "dtc/env.step": agg(2, step_host, step_wait),
               "dtc/act": agg(3, 0.006),
               "dtc/update": agg(1, 0.5, 0.0),
               "dtc/sync/gravity": agg(syncs, sync_wait, sync_wait),
               "dtc/sync/clock": agg(2, 0.002, 0.002)}))


def synthetic_trace(ops_per_step=4, steps=2):
    """`steps` env.step ranges of `ops_per_step` device ops each."""
    ev = []
    for s in range(steps):
        t = 1000.0 * s
        ev.append(dict(ph="X", cat="user_annotation", name="env.step", ts=t,
                       dur=500.0))
        for k in range(ops_per_step):
            c = s * 100 + k
            ev.append(dict(ph="X", cat="cuda_runtime",
                           name="cudaLaunchKernel", ts=t + 10 * (k + 1),
                           dur=2.0, args={"correlation": c}))
            ev.append(dict(ph="X", cat="kernel", name="k", ts=t + 600 + k,
                           dur=1.0, args={"correlation": c}))
    return Trace.from_events(ev)


def run_of(rows, trace=None):
    m = manifest.load()
    cell = manifest.cell(m, m["workloads"][0]["name"])
    return Run(cell=cell, mix=cell["mix"], num_envs=1024, env_steps=1,
               setup_s=1.0, window_s=1.0, calls=len(rows), rows=rows,
               peak_window_bytes=0, call_s=[1.0] * len(rows), trace=trace)


def read(name, run):
    return manifest.reader(name)(run)


def test_readers_on_synthetic_rows():
    # two calls: steps of 10 and 14 ms host, 2 and 4 ms of it blocked
    rows = [row(0.010, 0.002, 4, 0.002), row(0.014, 0.004, 6, 0.004, 1)]
    run = run_of(rows, synthetic_trace(ops_per_step=4))
    assert read("step_host_ms", run) == pytest.approx(
        1e3 * (0.008 + 0.010) / 4)
    assert read("act_host_ms", run) == pytest.approx(1e3 * 0.012 / 6)
    assert read("update_host_ms", run) == pytest.approx(500.0)
    # blocked: the implicit syncs' 2 and 4 ms, the clocks' 2 ms each call
    assert read("sync_wait_ms", run) == pytest.approx((4 + 6) / 2)
    assert read("host_syncs", run) == pytest.approx((4 + 2 + 6 + 2) / 2)
    assert read("step_device_ops", run) == 4
    assert read("step_host_us_per_op", run) == pytest.approx(
        1e3 * 4.5 / 4)


def test_readers_read_nothing_without_the_tracer():
    """The parent program's rows carry no "trace": every new metric reads
    None, whatever the device trace holds."""
    plain = [dict(collection_time=0.3, learning_time=0.6)] * 2
    for tr in (None, synthetic_trace()):
        run = run_of(plain, tr)
        assert {n: read(n, run) for n in NEW} == dict.fromkeys(NEW)
    # the tracer's rows without a device trace: the ops-based one alone
    run = run_of([row(0.01, 0.0, 1, 0.001)])
    assert read("step_host_us_per_op", run) is None
    assert read("step_host_ms", run) == pytest.approx(5.0)


def test_entries():
    """Each new metric reports in both cells and moves the rate."""
    m = manifest.load()
    by = {e["name"]: e for e in m["per_layer"]}
    cells = [w["name"] for w in m["workloads"]]
    for n in NEW:
        assert by[n]["workloads"] == cells and by[n]["moves"] == \
            "env_steps_per_s"
        assert (manifest.BENCH / "metrics" / f"{n}.py").exists()


@pytest.mark.cuda
def test_syncs_and_launches_on_the_card(card):
    """One warmed-up learn(1) at 4096 envs under torch's sync debug mode:
    every synchronizing call torch warns of is one the tracer counts
    (syncs), the same ones warn with tracing off (the tracer syncs
    nothing itself), and K1 launches once a step."""
    import torch
    from harness import program
    from deep_tracking_control_tpu_torch.utils import trace

    cell = manifest.cell(manifest.load(), "lite3_dtc.train.n32768")
    mix = dict(cell["mix"], num_envs=4096)
    runner = program.build(cell["config_file"], mix, 2 ** 31 + 11, card)
    program.call(runner, mix, first=True)           # every shape warmed up
    torch.cuda.synchronize()

    def learn():
        """The row, and the sites torch warned of a sync at: {file:line:
        count} (torch 2.11 does not warn of torch.cuda.synchronize, the
        runner's explicit syncs)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                (r,) = runner.learn(1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message))
        return r, sites

    r, sites = learn()
    tr = r["trace"]
    print("sync sites", dict(sites), "trace", tr["syncs"],
          tr["explicit_syncs"])
    assert sum(sites.values()) == tr["syncs"], (dict(sites), tr["syncs"])
    assert tr["explicit_syncs"] == 2
    steps = runner.cfg.runner.num_steps_per_env
    assert tr["launches"]["K1"] == steps
    assert tr["launches"]["K9"] == 1
    was = trace.enabled
    trace.enabled = False
    try:
        r_off, sites_off = learn()
    finally:
        trace.enabled = was
    assert "trace" not in r_off and sites_off == sites
