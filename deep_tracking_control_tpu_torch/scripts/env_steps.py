"""Collection and train-iteration env-steps/s of the default route at the
lite3_dtc task's 4096 envs, taken as chip_smoke.py phases 4 and 5 take
them: one warm-up collect, then 3 timed collects; one warm-up learn(1),
then a timed learn(3), with each of its iterations' collection and
learning (update) seconds and the tracer's aggregates (utils/trace.py:
host seconds per span, blocking syncs, kernel launches).  Then one collect
and one update, each under torch.profiler: wall ms, the launch calls'
self CPU ms, device ms and device ops.  Last the tracer's own cost: host
ns per span with tracing on and off.

    python deep_tracking_control_tpu_torch/scripts/env_steps.py

Needs a CUDA device.  Times the package of the checkout that holds this
file.  The host's speed varies more between machines than between two
versions of the code, so two checkouts are compared by runs of this file
from each of them, alternating, on one machine (copy the file into the
other checkout's scripts/ where it lacks it).  Prints one JSON line.
"""
import json
import os
import subprocess
import sys
import time

ITERS = 3
SPANS = 100_000           # spans timed for the tracer's cost
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def host_profile(torch, fn):
    """One synchronized run of fn under torch.profiler (CPU and CUDA)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    launch = [e for e in ev if e.key in LAUNCH_CALLS]
    return out, dict(
        wall_ms=wall * 1e3,
        launch_cpu_ms=sum(e.self_cpu_time_total for e in launch) / 1e3,
        # the kernels alone: a CPU op's entry repeats its kernels' time
        device_ms=sum(e.self_device_time_total for e in ev
                      if e.device_type == DeviceType.CUDA) / 1e3,
        device_ops=sum(e.count for e in ev
                       if e.device_type == DeviceType.CUDA))


def span_ns(trace, on: bool) -> float:
    """Host ns of one span, opened and closed inside an open span, with
    tracing on or off (the median of 5 runs of SPANS spans)."""
    was, trace.enabled = trace.enabled, on
    try:
        runs = []
        for _ in range(5):
            with trace.span("dtc/cost"):
                t0 = time.perf_counter_ns()
                for _ in range(SPANS):
                    with trace.span("dtc/cost/inner"):
                        pass
                runs.append((time.perf_counter_ns() - t0) / SPANS)
        return sorted(runs)[2]
    finally:
        trace.enabled = was


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("env_steps: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from deep_tracking_control_tpu_torch.tasks import registry
    from deep_tracking_control_tpu_torch.utils import trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    task, train = registry.get_cfgs("lite3_dtc")
    env = LeggedEnv(task, device="cuda")
    runner = OnPolicyRunner(env, train)
    steps = train.runner.num_steps_per_env * env.num_envs
    runner.collect()              # warm-up: allocator, cuBLAS heuristics
    torch.cuda.synchronize()
    collect_s = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        runner.collect()
        torch.cuda.synchronize()
        collect_s.append(time.perf_counter() - t0)
    runner.learn(1)               # warm-up: the update's allocations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = runner.learn(ITERS)
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    (batch, _), collect_prof = host_profile(torch, runner.collect)
    _, update_prof = host_profile(
        torch, lambda: runner.ppo.update(batch, runner.generator))
    print(json.dumps(dict(
        root=root, card=card, num_envs=env.num_envs,
        collect_env_steps_s=ITERS * steps / sum(collect_s),
        learn_env_steps_s=ITERS * steps / learn_s,
        collect_s=collect_s, learn_s=learn_s,
        learn_collection_s=[r["collection_time"] for r in rows],
        learn_update_s=[r["learning_time"] for r in rows],
        learn_trace=[r["trace"] for r in rows],
        collect_profile=collect_prof, update_profile=update_prof,
        span_ns_on=span_ns(trace, True), span_ns_off=span_ns(trace, False))))


if __name__ == "__main__":
    main()
