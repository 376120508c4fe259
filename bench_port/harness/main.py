"""One run of one cell: set-up (build, the warm-up call), the checked
calls, the measured window, the trace's reading, the correctness check,
the result line.

    python bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up ends after the first of CHECKED_CALLS calls of the window's own
kind (a learn iteration, or a collect), which warms up every shape; the
others run after it, on the path the window times, and all are followed
by the reference after the window.  Their boundaries' host copies count
in neither set-up nor the window.  The window repeats the call on the same
runner until --seconds have passed; its rate is the env-steps of every
call in it over the synchronized seconds from its start to the end of its
last call.  With --trace 1 the calls run inside the benchmark's ranges,
calls 2 to 1 + TRACED_CALLS of the window under torch.profiler (their time
not counted towards --seconds), and the line carries the per-layer
metrics; with --trace 0 the end-to-end ones.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "deep_tracking_control_tpu")
CHECKED_CALLS = 3          # calls the reference follows; the first warms up
TRACED_CALLS = 2           # profiled calls of a --trace 1 run


@dataclass
class Run:
    """What a metric's reader reads (bench_port/metrics/<name>.py)."""
    cell: dict
    mix: dict
    num_envs: int
    env_steps: int                # a call's
    setup_s: float
    window_s: float
    calls: int                    # whole calls in the window
    rows: list                    # the rows of the unprofiled calls
    peak_window_bytes: int
    call_s: list = field(default_factory=list)  # unprofiled calls' seconds
    trace: object = None          # harness.trace.Trace of the traced calls
    extra: dict = field(default_factory=dict)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not hold, compared
    whole (deep_tracking_control_tpu_torch is not deep_tracking_control_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "nvidia-smi unavailable"


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def read_trace(prof):
    """The profiler's events through its Chrome export (in TMPDIR, removed
    after reading)."""
    from .trace import Trace
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return Trace.from_events(events)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, mix_override: dict | None = None,
             stand_ins=()):
    """Set-up, window and check of one cell; returns (Run, numbers,
    {stand-in: numbers}, device dict)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import check, program
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix = dict(cell["mix"], **(mix_override or {}))
    cfg_file = cell["config_file"]
    cuda = torch.device(device).type == "cuda"

    # ---- set-up: build, then the first checked call (the warm-up of
    # every shape the window uses); then the other checked calls, on the
    # warmed-up path.  The captures' host copies count in neither ----
    runner = program.build(cfg_file, mix, seed, device)
    t_built = _sync(device) - t_start
    cap = program.Capture(runner, CHECKED_CALLS)
    cap.call(mix, first=True)
    setup_s = _sync(device) - t_start - cap.seconds
    t_checked = _sync(device)
    for _ in range(CHECKED_CALLS - 1):
        cap.call(mix)
    checked_s = _sync(device) - t_checked

    # ---- the window ----
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    traced = TRACED_CALLS if trace else 0
    rows, call_s, calls, profiled_s, prof = [], [], 0, 0.0, None
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(program.ranges(runner))
        t0 = _sync(device)
        while True:
            profiled = 1 <= calls <= traced
            tc = _sync(device)
            if calls == 1 and traced:
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else []))
                prof.start()
            with (record_function("iteration") if trace
                  else contextlib.nullcontext()):
                row = program.call(runner, mix)
            calls += 1
            if prof is not None and calls == 1 + traced:
                _sync(device)
                prof.stop()
            t1 = _sync(device)
            if profiled:
                profiled_s += t1 - tc
            else:
                call_s.append(t1 - tc)
                if row is not None:
                    rows.append(row)
            if t1 - t0 - profiled_s >= seconds and calls > traced:
                break
    window_s = t1 - t0
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak_process = max(peak_setup, peak_window)
    tr = read_trace(prof) if prof is not None else None
    del prof
    run = Run(cell=cell, mix=mix, num_envs=mix["num_envs"],
              env_steps=program.env_steps(runner), setup_s=setup_s,
              window_s=window_s, calls=calls, rows=rows,
              peak_window_bytes=peak_window, call_s=call_s, trace=tr)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak_process))

    # ---- the program's state goes before the reference runs ----
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.extra.update(built_s=t_built, captured_gib=cap.nbytes() / 2 ** 30,
                     capture_s=cap.seconds, checked_s=checked_s)
    t_check = time.perf_counter()
    numbers, others = check.judge(cfg_file, mix, seed, cap, device,
                                  stand_ins=stand_ins)
    run.extra["check_s"] = time.perf_counter() - t_check
    return run, numbers, others, dev


def metrics_of(run: Run, entries: list) -> dict:
    from . import manifest
    out = {}
    for m in entries:
        v = manifest.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out


def breakdown(run: Run) -> dict | None:
    from .program import RANGES
    tr = run.trace
    span = tr.span("iteration") if tr is not None else None
    if span is None:
        return None
    return dict(device_ops=tr.top_ops(10),
                idle_gaps=tr.idle_by_host(*span, RANGES, 10))


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from . import check, manifest
    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, numbers, _, dev = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0", t_start)
    x = run.extra
    print(f"bench_port: set-up {run.setup_s:.3f} s (runner built at "
          f"{x['built_s']:.3f} s), checked calls 2-{CHECKED_CALLS} "
          f"{x['checked_s']:.3f} s, captures {x['captured_gib']:.2f} GiB in "
          f"{x['capture_s']:.3f} s, window {run.window_s:.3f} s ({run.calls} "
          f"calls; unprofiled calls "
          f"{' '.join(f'{t:.3f}' for t in run.call_s)} s), check "
          f"{x['check_s']:.3f} s", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}", file=sys.stderr)
        return 3
    correct, rows = check.verdict(numbers, cell["limits"])
    entries = cell["per_layer"] if args.trace else cell["end_to_end"]
    result = dict(correct=bool(correct), attempted=run.calls, failed=0,
                  metrics=metrics_of(run, entries), device=dev)
    if args.trace and run.trace is not None:
        span = run.trace.span("iteration")
        dev["busy_s"] = run.trace.busy_s(*span)
        dev["window_s"] = (span[1] - span[0]) * 1e-6
        result["breakdown"] = breakdown(run)
    # the numbers compared, each beside its limit: last on stderr, and
    # last in the result line (a number that is not finite reads null)
    result["checks"] = {n: dict(value=v if v is not None and math.isfinite(v)
                                else None, limit=lim) for n, v, lim in rows}
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    # the card and its power limit, on a line before the shares
    print(f"card: {card_line()}", flush=True)
    print(json.dumps(result), flush=True)
    return 0
