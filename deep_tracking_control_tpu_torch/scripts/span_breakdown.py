"""Host and device time of each of the port's spans, and the device's idle
time by the program span the host was in, for one benchmark cell on the
card.

    python deep_tracking_control_tpu_torch/scripts/span_breakdown.py \\
        --workload lite3_dtc.train.n32768 [--seed N] [--iters 3]

Builds the cell's runner through the benchmark's harness (bench_port/ of
this checkout: configuration, mix, weights), runs the warm-up learn
iteration, --iters unprofiled ones, whose rows give the tracer's host
seconds per span (utils/trace.py), and 2 under torch.profiler, whose
trace gives the device operations launched inside each span's ranges and
the device's idle time by where the host was
(bench_port/harness/trace.py `Trace.idle_by_host`, the program's span
names as its order, outermost first).  Prints one JSON line: per span
and learn iteration its count, host ms, the ms blocked in syncs, device
ops and device ms; the idle seconds over the 2 profiled iterations.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROFILED = 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lite3_dtc.train.n32768")
    ap.add_argument("--seed", type=int, default=3100001616)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("span_breakdown: no CUDA device")
    sys.path[:0] = [str(ROOT / "bench_port"), str(ROOT)]
    from harness import manifest, program
    from harness.main import read_trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(manifest.load(), args.workload)
    mix = cell["mix"]
    runner = program.build(cell["config_file"], mix, args.seed, "cuda:0")
    program.call(runner, mix, first=True)
    rows = [program.call(runner, mix) for _ in range(args.iters)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            program.call(runner, mix)
        torch.cuda.synchronize()
    tr = read_trace(prof)
    spans = {}
    for name in rows[0]["trace"]["spans"]:
        aggs = [r["trace"]["spans"][name] for r in rows]
        spans[name] = dict(
            count=aggs[0]["count"],
            host_ms=1e3 * sum(a["host_s"] for a in aggs) / len(rows),
            wait_ms=1e3 * sum(a["wait_s"] for a in aggs) / len(rows),
            device_ops=len(tr.in_range(name)) / PROFILED,
            device_ms=1e3 * tr.device_s(name) / PROFILED)
    # outer spans open before the spans inside them
    order = tuple(sorted((n for n in spans if tr.ranges.get(n)),
                         key=lambda n: tr.ranges[n][0][0]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(dict(
        workload=args.workload, card=card, seed=args.seed,
        iteration_s=[r["collection_time"] + r["learning_time"] for r in rows],
        syncs=[r["trace"]["syncs"] + r["trace"]["explicit_syncs"]
               for r in rows],
        spans=spans,
        idle_s=tr.idle_by_host(*tr.span("dtc/learn"), order, 40))))


if __name__ == "__main__":
    main()
