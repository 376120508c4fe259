#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure ends the run non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the CUDA kernels from deep_tracking_control_tpu_torch/csrc;
  3. the lite3_dtc env's terrain generator (it must be the native one, as
     in the JAX package's env); each kernel against its plain PyTorch
     version on the inputs of a real lite3_dtc step at 4096 envs, with the
     kernel and plain times (a kernel row's device time twice: the call's,
     all the work its wrapper queues, and its CUDA kernel's alone, found
     by the kernel's symbol in the profiler's events, and its launch as
     the profiler recorded it: grid, block and registers a thread, held to
     the shape the wrapper states): the
     physics, sampler and planner kernels, the reward kernel (also on
     random inputs that switch on all 33 terms, with and without the
     positive clip), the obs kernel (against its plain version fed the
     noise kernel's draws for the same seed; ptxas's registers and stack
     from the build log, in the text) and the noise kernel (bit for bit
     at (4096, 693) and (4096, 53) and at the reset's shape; moments; two
     seeds differ; beside `uniform_` on a CUDA generator, and at the
     reset's shape beside its launch floors: an empty kernel and one that
     only loads the seed, at its recorded launch shape, from
     csrc/probe.cu);
  4. the collection path: LeggedEnv(lite3_dtc, 4096 envs) +
     ActorCriticDecoder + OnPolicyRunner, 3 collect() iterations of 24
     steps, every launch counted; the gather kernel against its plain
     version on the last collect's batch (bit-exact); then one step of a
     small env on the card against the same step on the CPU from the same
     state and noise seed (physics, heights, rewards, sums, obs);
  5. the training path: one warm-up learn(1), then learn(3) at 4096 envs
     (collect + the 5 x 4 minibatch PPO+VAE update), every launch counted,
     with the train-iteration env-steps/s and the collect/update split;
     then a profile of one collect and one update (device busy share,
     device ops, the largest items);
  6. one update of a small net on the card against the same update on the
     CPU (same batch and draws), and a save/load round trip on the card;
  7. the routes: under DTC_FUSED_WINDOW=0, DTC_PALLAS_SAMPLER=0 and
     DTC_STRICT_PARITY=1 in turn (set for the phase, then restored), a
     fresh 4096-env runner; the patch copy, the window copy and the
     decimation kernel's window variant against their plain versions on
     the route's real step (the copies bit for bit, the window variant bit
     for bit against the fused kernel on the same state); one warm-up and
     one timed collect with the route's launch counts; under strict parity
     learn(2) (float32 storage, sequential update, per-row gather); and a
     16-env step on the card against the CPU under the route;
  8. the other registry tasks, each at its registry width: lite3_rough
     (2048 envs, 45-dim obs, no planner), x30_rough (2048, the X30 at 0.1
     m a cell, 53-dim obs with a zero foothold block, the positive clip),
     x30_dtc and x30_dtc_descent (4096, the planner) and lite3_fast
     (4096, a plane: the plain decimation loop over sim_step, as in the
     JAX package); for each, its kernels against their plain versions on
     a recorded step of the task (rows "kernel (task)"; the decimation
     kernel also built in float64 against the plain version in float64,
     element by element, as float32 does not resolve the X30's step to
     its budget, and its float32 rounding against the plain version's:
     check_float_build), one collect and
     one learn(1) with the route's launch counts (no planner kernel
     without the planner; no decimation or sampler kernel on the plane)
     and a profiled collect; then the staged X30 protocol at 4096 envs:
     x30_rough learn(2) and its checkpoint, loaded by an x30_dtc runner
     (policy and optimizers carried, env state kept fresh), x30_dtc
     learn(2);
  10. the deployment path (run before phase 9's lines): phase 5's runner
     saved to a checkpoint and loaded by each evaluation script's own
     set-up without the optimizers (the 4096-env state not adopted):
     play_single (1 env, 50 steps), play_plane (1 env, 50 steps on a
     plane: no decimation, sampler or planner kernel), teleop (4 envs,
     the keys w w a q n r, then ESC and the ASCII map), eval_stones (64
     envs, 200 steps on the stepping-stone world at difficulty 0.45),
     play (100 envs, 50 steps) and analyze_terminations (256 envs, 200
     steps on the curriculum world); for each, its kernels against their
     plain versions on a recorded step of its env (rows "kernel (script,
     N)", the noise kernel bit for bit at the reset's shape), its rollout
     with every launch counted and held to its route (debug_viz in play
     and teleop: the plain planner, no planner kernel), its report and
     env-steps/s; then act_teacher exported at batch 1 on the card
     (torch.export), loaded, and held to the inference policy: max abs
     err 0;
  11. the other policies (run before phase 9's lines), on phase 3's
     4096-env lite3_dtc env: a runner each of ActorCritic and the GRU and
     LSTM ActorCriticRecurrent (PolicyCfg widths: heads (512, 256, 128),
     rnn_hidden_size 256), a warm-up learn(1) and a timed learn(2) with
     every launch counted (the default route's kernels once a step; K9
     once an MLP update, never in a recurrent one), the collection and
     train-iteration env-steps/s and the update share, and a profile of
     one update (device ms, device ops); K9 bit for bit on the MLP
     runner's batch; the recurrent replay against the collected means and
     values, an act and the inference policy advancing its carry; one
     update_recurrent of a small GRU and LSTM net on the card against the
     CPU (TF32 checked off there); a GRU checkpoint through teleop's
     set-up at 4 envs (keys sent) and an MLP one through play_single's
     for 50 steps;
  12. more physics substeps, the generic FK/ABA and a robot that is not a
     4x3 quadruped (run before phase 9's lines), on the route of physics
     off (the patch copy, the plain decimation loop over sim_step, the
     plain samplers and planner; the reward, obs and noise kernels): (a)
     lite3_dtc at 4096 envs with two substeps a sim step, (b) a
     three-legged robot (Lite3's URDF without its HR_ leg, written at run
     time) on lite3_rough at 2048 envs, registered with registry.register;
     for each a warm-up and a timed collect, a profiled collect and
     learn(1) with every launch counted (the patch copy, reward, obs and
     noise kernels once a step, the gather once an update, no decimation,
     sampler or planner kernel) and a 16-env step on the card against the
     CPU; in (b) also the patch copy, reward, obs and noise kernels against
     their plain versions on a recorded step (rows "kernel (three-leg)");
     (c) one sim_step of the generic FK/ABA against the leg-batched one at
     4096 envs of Lite3 from (a)'s state, with the device time of each;
  13. the env axis sharded over torch.distributed ranks (run before phase
     9's lines): (a) the noise kernel at row offsets (D = 20, 17, 693 and
     53, rows 1, 2, 3, 5, 2048 and 4089) and the obs kernel at row0 2048
     on a 4096-env step's inputs cut in half, each bit for bit against the
     rows of the full-size output and against its plain version, with
     their times (rows "kernel (row offset)"); (b) one rank through
     parallel/distributed.py `initialize` (nccl), lite3_dtc at 4096 envs,
     learn(2) against the plain runner from the same seed: stats and
     params max abs err 0, the default route's launch counts, both
     env-steps/s; (c) two rank processes on the one card (gloo: NCCL
     refuses two ranks on one device), 2048 envs each, learn(2) at
     shuffle_strata 2 against one process at shuffle_strata 2: rank 1's
     noise draws of the first collect are rows 2048-4095 of the
     unsharded run's, bit for bit; params and generator states equal on
     both ranks, bit for bit; iteration 1's stats over its first two
     minibatch steps within 2e-3 rel + 1e-5 (the JAX package's budget
     for sharded against unsharded training), over all its steps within
     SHARD_WHOLE_LIMIT; the first VAE and main gradients, summed over
     the ranks, within SHARD_GRAD_REL / SHARD_GRAD_COS of W=1's; the
     first minibatch's CE-net outputs within SHARD_CENET_ATOL; beside
     them three noise witnesses, read the same way: W=1 with every
     minibatch's rows reversed, its gradients summed from its two
     halves, or its dense layers run on each half apart; each rank's
     launches the default route's; a rank that fails or outlives its
     time ends the run.  `--only 13` runs phases 1, 2 and 13 alone (and
     exits non-zero): a quicker check while the sharded path changes;
  14. the A/B training-outcome scripts (run before phase 9's lines):
     scripts/ab_granule.py's and ab_fused_step.py's `run_variant`, each
     variant (G=1 and G=16; sequential and fused) at 4096 envs for 2
     iterations, every launch counted (the init's one noise-kernel launch,
     then the default route's kernels once a step and the gather once an
     update), each variant's curve points and wall seconds, iteration 0
     equal in both variants of a script; `--only 14` runs phases 1, 2 and
     14 alone (and exits non-zero);
  9. a check that no kernel reads under its bytes read over the memory
     rate, a JSON line of the kernels (the main path's, then each at the
     other tasks' and the scripts' shapes; the main path's rows also carry
     phase 14's launches, "ab_launches"), the nvidia-smi line, and the
     result line.
Each kernel's bound is the least time the card could take for its work:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over 67 TFLOP/s (float32 off the
tensor cores; the noise generator's 32-bit integer operations are counted
at that rate too), both counted from this run's inputs.  Every device
time (kernel, plain version, library call) is of calls that each follow a
read of 256 MB, which leaves none of their inputs in the 50 MB L2; a
kernel may still read under its bound where its outputs stay in L2 when
it ends, never under its bytes read over the memory rate (phase 9).
Weights are random (seeded); nothing is downloaded.  Needs a CUDA device:
without one it stops before printing any result.
"""
import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NUM_ENVS = 4096
ITERS = 3
REPEATS = 20
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12        # H100 SXM float32, off the tensor cores
# Philox4x32-10 per output value: 10 rounds of 2 multiply-high, 2 multiply-
# low and 4 XORs, 9 pairs of key additions, per 4 values; then a shift, a
# conversion, a multiply and a subtraction
PHILOX_OPS = (10 * 8 + 9 * 2) / 4 + 4

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "decimation_step": ("deep_tracking_control_tpu_torch/csrc/substep.cu",
                        "deep_tracking_control_tpu/physics/pallas_substep.py:755"),
    "decimation_step_window": (
        "deep_tracking_control_tpu_torch/csrc/substep.cu",
        "deep_tracking_control_tpu/physics/pallas_substep.py:771"),
    "extract_patches": ("deep_tracking_control_tpu_torch/csrc/patch.cu",
                        "deep_tracking_control_tpu/ops/pallas_patch.py:63"),
    "extract_windows": ("deep_tracking_control_tpu_torch/csrc/patch.cu",
                        "deep_tracking_control_tpu/ops/pallas_patch.py:118"),
    "sample_all": ("deep_tracking_control_tpu_torch/csrc/sampler.cu",
                   "deep_tracking_control_tpu/terrain/pallas_sampler.py:184"),
    "plan_footholds": ("deep_tracking_control_tpu_torch/csrc/planner.cu",
                       "deep_tracking_control_tpu/env/pallas_planner.py:143"),
    "permute_groups": ("deep_tracking_control_tpu_torch/csrc/gather.cu",
                       "deep_tracking_control_tpu/experimental/pallas_gather.py:58"),
    "compute_rewards": ("deep_tracking_control_tpu_torch/csrc/rewards.cu",
                        "deep_tracking_control_tpu/experimental/pallas_rewards.py:495"),
    "compute_observations": ("deep_tracking_control_tpu_torch/csrc/obs.cu",
                             "deep_tracking_control_tpu/experimental/pallas_obs.py:157"),
    "uniform_pm1": ("deep_tracking_control_tpu_torch/csrc/rng.cu",
                    "deep_tracking_control_tpu/experimental/pallas_rng.py:64"),
}


# kernel -> the symbol of its CUDA kernel, as the profiler names it (every
# kernel of csrc/ lies in an anonymous namespace)
SYMBOLS = {
    "decimation_step": "substep_kernel",
    "decimation_step_window": "substep_kernel",
    "extract_patches": "copy_rows_kernel",
    "extract_windows": "copy_rows_kernel",
    "sample_all": "sample_all_kernel", "plan_footholds": "plan_kernel",
    "permute_groups": "gather_kernel", "compute_rewards": "rewards_kernel",
    "compute_observations": "obs_kernel", "uniform_pm1": "uniform_kernel",
}


# the kernels that each route launches once a step, beside the reward, obs
# and noise kernels, which run on every route
EVERY_ROUTE = ("compute_rewards", "compute_observations", "uniform_pm1")
DEFAULT_ROUTE = ("decimation_step", "sample_all", "plan_footholds")
ROUTES = {
    "DTC_FUSED_WINDOW=0": ({"DTC_FUSED_WINDOW": "0"},
                           ("extract_windows", "decimation_step_window",
                            "sample_all", "plan_footholds")),
    "DTC_PALLAS_SAMPLER=0": ({"DTC_PALLAS_SAMPLER": "0"},
                             ("extract_patches", "decimation_step_window",
                              "plan_footholds")),
    "DTC_STRICT_PARITY=1": ({"DTC_STRICT_PARITY": "1"}, ("extract_patches",)),
}
# the other registry tasks, each at its registry width (phase 8): task ->
# the kernels its route launches once a step beside EVERY_ROUTE.  Without
# the DTC planner no K3; a plane (lite3_fast) has no terrain tables, so no
# K1 or K2 either: the plain decimation loop over sim_step on the flat
# grid, as in the JAX package
NO_PLANNER = ("decimation_step", "sample_all")
TASKS = {"lite3_rough": NO_PLANNER, "x30_rough": NO_PLANNER,
         "x30_dtc": DEFAULT_ROUTE, "x30_dtc_descent": DEFAULT_ROUTE,
         "lite3_fast": ()}
# keys a kernel's entry of the JSON line carries where measured: K8's
# launch floors
EXTRA_KEYS = ("floor_empty_ms", "floor_seed_ms")
SWITCHES = ("DTC_FUSED_WINDOW", "DTC_PALLAS_SAMPLER", "DTC_PALLAS_PHYSICS",
            "DTC_PALLAS_PLANNER", "DTC_STRICT_PARITY")


def _counters():
    """(KERNELS name, wrapper, attribute) of every launch count."""
    from deep_tracking_control_tpu_torch.env import (cuda_obs, cuda_planner,
                                                     cuda_rewards)
    from deep_tracking_control_tpu_torch.ops import (cuda_gather, cuda_patch,
                                                     cuda_rng)
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    return [("decimation_step", cuda_substep.decimation_step, "launches"),
            ("decimation_step_window", cuda_substep.decimation_step,
             "window_launches"),
            ("extract_patches", cuda_patch.extract_patches, "launches"),
            ("extract_windows", cuda_patch.extract_windows, "launches"),
            ("sample_all", cuda_sampler.sample_all, "launches"),
            ("plan_footholds", cuda_planner.plan_footholds_fused, "launches"),
            ("permute_groups", cuda_gather.permute_groups, "launches"),
            ("compute_rewards", cuda_rewards.compute_rewards_fused,
             "launches"),
            ("compute_observations", cuda_obs.compute_observations_fused,
             "launches"),
            ("uniform_pm1", cuda_rng.uniform_pm1, "launches")]


def zero_launches():
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def launch_counts():
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def expected_launches(route_kernels, steps, updates=0):
    """The launch counts of `steps` env steps on a route that runs
    `route_kernels` (and EVERY_ROUTE) once a step, and of `updates`
    updates (one gather each)."""
    return {k: (steps if k in route_kernels + EVERY_ROUTE
                else updates if k == "permute_groups" else 0)
            for k in KERNELS}


@contextlib.contextmanager
def route_env(values):
    """The route's DTC_* switches in os.environ (every other switch unset)
    for a `with` block; the previous values come back after it."""
    saved = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def wall_ms(torch, fn, repeats=REPEATS):
    """Stream time per call of fn() over `repeats` back-to-back calls
    between two CUDA events (host overhead shows where it exceeds the
    device work)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / repeats


def is_symbol(key, symbol):
    """Whether a profiler event's name is the CUDA kernel `symbol` of
    csrc/ (a kernel in an anonymous namespace, maybe a template)."""
    return (f"(anonymous namespace)::{symbol}(" in key
            or f"(anonymous namespace)::{symbol}<" in key)


def _launch_records(prof):
    """{kernel name: set of (grid, block, registers a thread)} of a
    profiler session's kernel launches, from the trace it exports (the
    CUDA profiling interface's record of each launch)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    out = {}
    for e in trace.get("traceEvents", []):
        a = e.get("args") or {}
        if e.get("cat") == "kernel" and "grid" in a and "block" in a:
            out.setdefault(e["name"], set()).add(
                (tuple(a["grid"]), tuple(a["block"]),
                 a.get("registers per thread")))
    return out


def _device_events(torch, calls, launches=None):
    """The device events of calls() in one torch.profiler session (CUDA
    activity only), in the order they ran: a list of (name, device us);
    `launches`, a dict, takes the session's `_launch_records`.
    On the H100 host a session now and then records no device activity at
    all, mostly right after a session of thousands of kernels: it is run
    again after a pause of 1, 2 and 4 s, and the run fails if the last
    one is empty too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for pause in (0, 1, 2, 4):
        time.sleep(pause)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls()
        events = sorted((e.time_range.start, e.key, e.self_device_time_total)
                        for e in prof.events()
                        if e.device_type != DeviceType.CPU)
        if events:
            if launches is not None:
                launches.update(_launch_records(prof))
            return [(k, us) for _, k, us in events]
    raise AssertionError("the profiler saw no device time in 4 sessions")


_PROBES = {}
EVICT_BYTES = 256 << 20       # five times the H100's 50 MB L2


def _segments(events, mark):
    """The runs of events between one `mark` event and the next (the
    last run to the end)."""
    at = [i for i, (k, _) in enumerate(events) if k == mark]
    return [events[i + 1:j] for i, j in zip(at, at[1:] + [len(events)])]


def timing_probes(torch):
    """(evict, mark, the marker's event name, the eviction's event names
    in order).  evict() reads a 256 MB buffer (a float32 sum, no cast),
    so that a call timed after it finds none of its inputs in the 50 MB
    L2, as the bounds assume; reading, not writing, leaves no dirty lines
    whose write-back would slow the timed call.  mark() queues a spin kernel of
    one cycle, which nothing else launches: the profile of a timed call
    is the events between its marker and the next eviction."""
    if not _PROBES:
        buf = torch.ones(EVICT_BYTES // 4, dtype=torch.float32, device="cuda")

        def evict():
            buf.sum()

        def mark():
            torch.cuda._sleep(1)

        def marks():
            for _ in range(3):
                mark()
                torch.cuda.synchronize()
        evict()
        marks()
        names = {k for k, _ in _device_events(torch, marks)}
        if len(names) != 1:
            raise AssertionError(f"the marker queues {sorted(names)}")
        name = names.pop()

        def evictions():
            for _ in range(3):
                mark()
                evict()
                torch.cuda.synchronize()
            mark()
            torch.cuda.synchronize()
        runs = [[k for k, _ in r]
                for r in _segments(_device_events(torch, evictions), name)]
        if len(runs) < 3 or runs[-2] != runs[-3] or runs[-1]:
            raise AssertionError(f"the eviction's events vary: {runs}")
        _PROBES.update(evict=evict, mark=mark, name=name, pattern=runs[-2])
    return (_PROBES["evict"], _PROBES["mark"], _PROBES["name"],
            _PROBES["pattern"])


def device_profile(torch, fn, repeats=REPEATS, launches=None):
    """(events, calls seen) of `repeats` fn() calls in one profiler
    session: each call follows an L2 eviction and a marker
    (`timing_probes`) and is followed by a synchronize; events are
    (name, self device us, count), summed over the calls seen, the
    eviction's and the markers' left out.  The session now and then
    misses its first events: the calls seen are the markers seen.
    `launches`: as `_device_events`."""
    evict, mark, name, pattern = timing_probes(torch)

    def calls():
        for _ in range(repeats):
            evict()
            mark()
            fn()
            torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    runs = _segments(_device_events(torch, calls, launches), name)
    if not runs or len(runs) > repeats:
        raise AssertionError(f"{len(runs)} markers in {repeats} calls")
    total = {}
    for i, run in enumerate(runs):
        if i + 1 < len(runs):       # the next call's eviction ends the run
            if [k for k, _ in run[len(run) - len(pattern):]] != pattern:
                raise AssertionError(f"call {i}: no eviction after it")
            run = run[:len(run) - len(pattern)]
        for k, us in run:
            t, c = total.get(k, (0.0, 0))
            total[k] = (t + us, c + 1)
    return [(k, t, c) for k, (t, c) in total.items()], len(runs)


def device_ms(torch, fn, repeats=REPEATS):
    """Mean over the calls seen of the device time of all the work one
    fn() call queues (`device_profile`)."""
    events, seen = device_profile(torch, fn, repeats)
    return sum(us for _, us, _ in events) / 1e3 / seen


def device_split(torch, fn, symbol, repeats=REPEATS):
    """(call ms, kernel ms, device ops a call, the other ops' names,
    launch) of one fn() call, one profiler session over `repeats` calls:
    the device time of all the work the call queues, that of the CUDA
    kernel `symbol` alone, the number of device ops the call queues, the
    names of the ops other than the kernel, and the kernel's launch as the
    session recorded it, {"grid", "block", "registers"} (None where the
    trace holds none).  The call launches the kernel once, so the kernel's
    event count is the number of calls the session saw (now and then it
    misses the first one): the means are taken over that count."""
    launches = {}
    events, _ = device_profile(torch, fn, repeats, launches)
    own = [(us, c) for k, us, c in events if is_symbol(k, symbol)]
    seen = sum(c for _, c in own)
    if not own or seen > repeats:
        raise AssertionError(f"{seen} events of {symbol} in {repeats} calls "
                             f"among {[k[:60] for k, _, _ in events]}")
    shapes = set().union(*(v for k, v in launches.items()
                           if is_symbol(k, symbol)))
    if len(shapes) > 1:
        raise AssertionError(f"{symbol} launched as {sorted(shapes)}")
    launch = (dict(zip(("grid", "block", "registers"), shapes.pop()))
              if shapes else None)
    return (sum(us for _, us, _ in events) / 1e3 / seen,
            sum(us for us, _ in own) / 1e3 / seen,
            sum(c for _, _, c in events) / seen,
            sorted(k for k, _, _ in events if not is_symbol(k, symbol)),
            launch)


def check_launch(name, launch, blocks, threads):
    """Raise unless a kernel's recorded launch (`device_split`) was
    `blocks` x `threads`, one-dimensional: the shape its wrapper states."""
    want = dict(grid=(blocks, 1, 1), block=(threads, 1, 1))
    if launch is None or any(launch[k] != v for k, v in want.items()):
        raise AssertionError(f"{name}: launched as {launch}, its wrapper "
                             f"states {want}")


def timings(torch, name, kernel, plain, plain_repeats=REPEATS):
    """Kernel row `name`: the call's device ms (`ms`), its CUDA kernel's
    alone (`kernel_ms`), the device ops a call queues, the plain version's
    device ms, and both stream times."""
    ms, kernel_ms, ops, others, launch = device_split(torch, kernel,
                                                      SYMBOLS[name])
    return dict(ms=ms, kernel_ms=kernel_ms, device_ops=ops, others=others,
                launch=launch,
                plain_ms=device_ms(torch, plain, plain_repeats),
                wall_ms=wall_ms(torch, kernel),
                plain_wall_ms=wall_ms(torch, plain, plain_repeats))


def record_kernel_inputs(env, params, state, gen, steps=3, slots=None):
    """Run `steps` env steps and keep the arguments each kernel got in the
    last one (the wrappers are wrapped, then restored).  slots: (module,
    attribute, name) of the wrappers; default the default route's."""
    import torch
    from deep_tracking_control_tpu_torch.env import (cuda_obs, cuda_planner,
                                                     cuda_rewards)
    from deep_tracking_control_tpu_torch.ops import cuda_rng
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    calls = {}
    slots = slots or (
        (cuda_substep, "decimation_step", "decimation_step"),
        (cuda_sampler, "sample_all", "sample_all"),
        (cuda_planner, "select_footholds", "plan_footholds"),
        (cuda_rewards, "compute_rewards_fused", "compute_rewards"),
        (cuda_obs, "compute_observations_fused", "compute_observations"),
        (cuda_rng, "uniform_pm1", "uniform_pm1"))
    originals = [getattr(mod, attr) for mod, attr, _ in slots]

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            # the reward kernel adds to its last argument (the episode
            # sums) in place: keep them as they came in
            kept = ((*args[:-1], args[-1].clone()) if name == "compute_rewards"
                    else args)
            calls[name] = (kept, kwargs)
            return fn(*args, **kwargs)
        return wrapped
    for (mod, attr, name), fn in zip(slots, originals):
        setattr(mod, attr, recorder(name, fn))
    try:
        for _ in range(steps):
            actions = 0.3 * torch.randn((env.num_envs, env.num_actions),
                                        generator=gen, device=env.device)
            state, _ = env.step(params, state, actions, gen)
    finally:
        for (mod, attr, _), fn in zip(slots, originals):
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    return calls, state


def max_err(pairs):
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def check_close(name, got, want, atol, rtol):
    """Raise unless |got - want| <= atol + rtol |want| everywhere."""
    import torch
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond atol {atol} rtol "
            f"{rtol}, max abs err {float((got - want).abs().max())}")


def plain_float64(fn, args, kwargs):
    """fn(*args, **kwargs) with every float32 tensor of the arguments (in
    tuples, lists and dicts) taken to float64, and float64 as the default
    dtype for the tensors fn makes: a plain version in double precision."""
    import torch

    def wide(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.double()
        if isinstance(x, dict):
            return {k: wide(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(wide(v) for v in x)
        return x
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return fn(*wide(args), **wide(kwargs))
    finally:
        torch.set_default_dtype(old)


def check_float_build(name, got, got64, want, want64, atol, rtol):
    """The rounding of a float32 kernel against its plain version's, each
    from its own float64 run (got64: the kernel's source built in double;
    want64: the plain version in double): raise unless `got` departs from
    got64 by more than atol + rtol |got64| at no more than twice as many
    elements as `want` departs from want64, plus one in a thousand.
    Returns (elements of got beyond that budget of want, got's and want's
    elements beyond it of their float64 runs)."""
    import torch
    beyond = int(((got - want).abs() > atol + rtol * want.abs()).sum())
    off_got = int(((got.double() - got64).abs()
                   > atol + rtol * got64.abs()).sum())
    off_want = int(((want.double() - want64).abs()
                    > atol + rtol * want64.abs()).sum())
    if (not bool(torch.isfinite(got).all())
            or off_got > 2 * off_want + got.numel() // 1000):
        raise AssertionError(
            f"{name}: the kernel departs from its float64 build beyond atol "
            f"{atol} rtol {rtol} at {off_got} of {got.numel()} elements, the "
            f"plain version from its float64 run at {off_want}")
    return beyond, off_got, off_want


def tensor_bytes(tree, skip=()):
    """Bytes of every tensor in a nest of tuples, lists, dicts and
    dataclasses, each counted once; tensors whose id is in `skip` (the
    terrain tables, of which a kernel reads only the cells its queries
    touch) are left out."""
    import torch
    seen = set(skip)
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return total


# aten ops that move or make data and compute nothing
_MOVES = {
    "view", "_unsafe_view", "reshape", "expand", "clone", "copy", "_to_copy",
    "cat", "stack", "slice", "select", "index", "index_select", "gather",
    "unsqueeze", "squeeze", "permute", "transpose", "t", "contiguous",
    "alias", "detach", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "fill", "arange",
    "lift_fresh", "split", "split_with_sizes", "unbind", "narrow", "as_strided",
    "new_empty", "new_zeros", "new_full", "scalar_tensor", "_local_scalar_dense",
    "index_put", "scatter", "masked_fill", "repeat", "flip", "roll", "set"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
               "argmin", "any", "all", "norm", "linalg_vector_norm", "var",
               "std", "cumsum", "cumprod", "logsumexp", "sort", "topk"}


def count_ops(fn):
    """Operations of one fn() call, counted per element as PyTorch's
    dispatcher sees them: an elementwise op counts one per output element,
    a reduction one per input element, a product 2*M*N*K, and data
    movement none."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def numel(x):
        if isinstance(x, torch.Tensor):
            return x.numel()
        if isinstance(x, (tuple, list)):
            return sum(numel(v) for v in x)
        return 0

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ("mm", "addmm"):
                a, b = args[-2], args[-1]
                Counter.ops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
            elif name in ("bmm", "baddbmm"):
                a, b = args[-2], args[-1]
                Counter.ops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            elif name in _REDUCTIONS:
                Counter.ops += numel(args[0])
            elif name not in _MOVES:
                Counter.ops += numel(out)
            return out

    with Counter():
        fn()
    return Counter.ops


def bound(read, written, ops):
    """bound_ms and bound_by: the larger of the bytes read and written
    over the memory rate and the operations over the float32 rate; and
    read_ms, the bytes read alone over the memory rate: the least time of
    a call whose inputs all come from HBM (the L2 may hold its outputs
    when it ends and write them back after)."""
    by_bytes = (read + written) / PEAK_BYTES_S * 1e3
    by_ops = ops / PEAK_F32_OPS_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                read_ms=read / PEAK_BYTES_S * 1e3)


def three_leg_urdf(path):
    """Write a robot that is not a 4x3 quadruped to `path`: Lite3's URDF
    (the port's `to_urdf`, so nothing is downloaded) with every HR_ link
    and joint removed, three legs of three joints on the torso (10 dynamic
    bodies, 9 joints, 3 feet).  Returns `path`."""
    import xml.etree.ElementTree as ET
    from deep_tracking_control_tpu_torch.robot import quadrupeds
    root = ET.fromstring(quadrupeds.to_urdf(quadrupeds.lite3()))
    for el in list(root):
        if el.get("name", "").startswith("HR_"):
            root.remove(el)
    with open(path, "w") as f:
        f.write(ET.tostring(root, encoding="unicode"))
    return path


def three_leg_task(registry, urdf, num_envs=None):
    """lite3_rough (no planner, the 45-dim layout) with the three-legged
    robot of `urdf`: 9 actions and 36-dim obs; its registry width unless
    num_envs is given.  Returns (task, train)."""
    task, train = registry.get_cfgs("lite3_rough")
    env = dataclasses.replace(task.env, num_actions=9, num_observations=36)
    if num_envs is not None:
        env = dataclasses.replace(env, num_envs=num_envs)
    return dataclasses.replace(
        task, env=env, asset=dataclasses.replace(task.asset, robot=urdf)), train


def synthetic_ctx(N: int, seed: int, device):
    """Random step quantities on which every branch of every term is taken
    by some env: the inputs that hold the kernel to its plain version on
    all 33 terms (here and in tests/test_torch_cuda.py).  The same numpy
    draws, in the same order, as the JAX package's
    tests/test_pallas_rewards.py `make_ctx`."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    B = 13

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def f(*s):
        return t(r.normal(size=s).astype(np.float32))

    def u(*s):
        return t(r.random(s).astype(np.float32))
    feet_contact = r.random((N, 4)) < 0.6
    last_contacts = r.random((N, 4)) < 0.6
    return dict(
        dt=0.02,
        base_lin_vel=f(N, 3), base_ang_vel=f(N, 3),
        projected_gravity=f(N, 3),
        dof_pos=f(N, 12), dof_vel=2.0 * f(N, 12), last_dof_vel=2.0 * f(N, 12),
        actions=f(N, 12), last_actions=f(N, 12), last_actions_2=f(N, 12),
        torques=20.0 * f(N, 12),
        contact_forces=30.0 * f(N, B, 3),
        feet_idx=t([3, 6, 9, 12], torch.int64),
        penalised_idx=t([2, 5, 8, 11], torch.int64),
        hip_dof_idx=t([0, 3, 6, 9], torch.int64),
        feet_contact=t(feet_contact, torch.bool),
        last_contacts=t(last_contacts, torch.bool),
        contact_filt=t(feet_contact | last_contacts, torch.bool),
        feet_air_time=0.3 * u(N, 4),
        stumb_buffer=t(r.random((N, 5, 4)) < 0.2, torch.bool),
        commands=f(N, 4),
        cmd_buffer=f(N, 10, 4), lin_vel_buffer=f(N, 10, 2),
        ang_vel_buffer=f(N, 10, 1),
        lin_vel_x_max=t(2.5),
        ang_vel_yaw_max=3.14,
        tracking_sigma=0.25,
        default_dof_pos=f(1, 12),
        soft_dof_pos_limits=(t(np.full(12, -2.0)), t(np.full(12, 2.0))),
        dof_vel_limit=t(np.full(12, 20.0)),
        soft_dof_vel_limit=0.9,
        torque_limit=t(np.full(12, 35.0)),
        soft_torque_limit=0.85,
        max_contact_force=100.0,
        max_acc=300.0,
        base_height_target=0.32,
        robot_mass=12.0 + u(N),
        foot_positions=f(N, 4, 3), foot_velocities=f(N, 4, 3),
        last_foot_velocities=f(N, 4, 3),
        measured_foot_clearance=0.4 * u(N, 4),
        measured_heights=0.3 * f(N, 693),
        plane_pinv=t(np.asarray(r.normal(size=(3, 693)) * 0.01, np.float32)),
        pitch_est=0.1 * f(N),
        terrain_levels=t(r.integers(0, 9, N), torch.int32),
        acc_points=t(np.asarray(r.normal(size=(8, 3)), np.float32)),
        optimal_footholds_world=f(N, 4, 3),
        root_z=0.3 + 0.1 * u(N),
        env_origin_z=torch.zeros((N,), device=device),
        reset_buf=t(r.random(N) < 0.1, torch.bool),
        time_out_buf=t(r.random(N) < 0.05, torch.bool),
    )


def check_rewards(name, args):
    """K6 against its plain version from the same episode sums, with the
    budgets of the JAX package's tests/test_pallas_rewards.py: rew and sums
    rtol 2e-5 / atol 1e-5, feet_air_time 1e-6 / 1e-7, pitch_est 1e-5 /
    1e-6, the stumble ring exact.  Returns the max abs error of rew and
    sums."""
    import torch
    from deep_tracking_control_tpu_torch.env import cuda_rewards
    *head, sums = args
    s_k, s_p = sums.clone(), sums.clone()
    rew, upd = cuda_rewards.compute_rewards_fused(*head, s_k)
    prew, pupd = cuda_rewards.rewards_plain(*head, s_p)
    check_close(f"{name} rew", rew, prew, 1e-5, 2e-5)
    check_close(f"{name} episode sums", s_k, s_p, 1e-5, 2e-5)
    if set(upd) != set(pupd):
        raise AssertionError(f"{name}: updates {sorted(upd)}, plain "
                             f"{sorted(pupd)}")
    budgets = dict(feet_air_time=(1e-7, 1e-6), pitch_est=(1e-6, 1e-5))
    for k, v in upd.items():
        if k == "stumb_buffer":
            if v.dtype != torch.bool or not torch.equal(v, pupd[k]):
                raise AssertionError(f"{name}: stumble ring differs")
        else:
            check_close(f"{name} {k}", v, pupd[k], *budgets[k])
    return max_err([(rew, prew), (s_k, s_p)])


def check_observations(args):
    """K7 against its plain version fed the noise kernel's draws for the
    same seed (1e-6 + 1e-6 rel); the plain version's own draws must be
    those draws.  Returns (max abs error, the kernel's outputs, the
    draws)."""
    import torch
    from deep_tracking_control_tpu_torch.env import cuda_obs
    from deep_tracking_control_tpu_torch.ops import cuda_rng
    seed = args[-1]
    N, H = args[10].shape
    num_obs = args[14].shape[0]
    got = cuda_obs.compute_observations_fused(*args)
    draws = dict(height_noise=cuda_rng.uniform_pm1(seed, (N, H), 0),
                 obs_noise=cuda_rng.uniform_pm1(seed, (N, num_obs), 1))
    fed = cuda_obs.observations_plain(*args, **draws)
    own = cuda_obs.observations_plain(*args)
    for name, a, b, c in zip(("obs", "privileged", "history"), got, fed, own):
        check_close(f"compute_observations {name}", a, b, 1e-6, 1e-6)
        if not torch.equal(b, c):
            raise AssertionError(f"compute_observations {name}: the plain "
                                 f"version's draws are not the noise kernel's")
    return max_err(list(zip(got, fed))), got, draws


def ptxas_usage(symbol):
    """{mangled name: (registers, stack bytes)} of each entry function
    whose name holds `symbol`, from ptxas's lines in the library's build
    log (empty if the log is not at hand)."""
    import re
    from deep_tracking_control_tpu_torch import cuda_build
    found, name = {}, None
    for line in cuda_build.build_log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1) if symbol in entry.group(1) else None
            if name:
                found[name] = [None, None]
        elif name and (m := re.search(r"(\d+) bytes stack frame", line)):
            found[name][1] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items()}


# the launch-floor probes of csrc/probe.cu: an empty kernel, and one whose
# threads only load the 16-byte seed
PROBES = {"empty": (0, "empty_kernel"), "seed_load": (1, "seed_kernel")}


def launch_floors(torch, seed, blocks, threads, repeats=REPEATS):
    """{probe: device ms of its kernel} at the launch shape blocks x
    threads (each probe's recorded launch held to it), each call after an
    L2 eviction as every timed call here."""
    from deep_tracking_control_tpu_torch import cuda_build
    sink = torch.zeros(1, dtype=torch.int32, device=seed.device)
    out = {}
    for name, (what, symbol) in PROBES.items():
        def probe(what=what):
            cuda_build.launch("dtc_launch_floor", what, cuda_build.ptr(seed),
                              cuda_build.ptr(sink), blocks, threads,
                              cuda_build.stream_ptr(seed.device))
        split = device_split(torch, probe, symbol, repeats)
        check_launch(symbol, split[4], blocks, threads)
        out[name] = split[1]
    return out


def shape_text(shape):
    blocks, threads, envs = shape
    return (f"launch shape {blocks} blocks x {threads} threads, {envs} envs "
            f"a block")


def planner_near_ties(got, want, scal, heights, stat, ny):
    """The envs where K3's selections (N, 20) differ from its plain
    version's, as an (N,) mask; raises unless each of them differs only
    where the kernel's pick ties the best total within 1e-4 or either
    pick's score lies within 1e-5 of the 0.1 gate (the two sums are taken
    in another order)."""
    from deep_tracking_control_tpu_torch.env import cuda_planner
    total, raw, hwx, hwy = cuda_planner.plan_objective(scal, heights, stat, ny)
    differ = (got != want).any(dim=1)
    for n in differ.nonzero().flatten().tolist():
        for leg in range(4):
            picks = []
            for out in (got, want):
                d = ((hwx[n] - out[n, 8 + leg]).abs()
                     + (hwy[n] - out[n, 12 + leg]).abs())
                picks.append(int(d.argmin()))
            near_tie = total[n, leg, picks[0]] <= total[n, leg].min() + 1e-4
            on_gate = any(abs(float(raw[n, k]) - 0.1) < 1e-5 for k in picks)
            if not (near_tie or on_gate):
                raise AssertionError(f"plan_footholds: env {n} leg {leg} "
                                     f"differs without a near-tie")
    return differ


def check_planner(got, want, scal, heights, stat, ny):
    """K3's gate: at most 2% of the envs differ from the plain version,
    each only at a near-tie (`planner_near_ties`).  Returns the (N,) mask
    of envs that differ."""
    differ = planner_near_ties(got, want, scal, heights, stat, ny)
    frac = float(differ.float().mean())
    if frac > 0.02:
        raise AssertionError(f"plan_footholds: {frac:.2%} of envs differ")
    return differ


def compare_kernels(calls, tables, phase=3, main_path=True,
                    float64_physics=None):
    """Each kernel that the recorded step ran (`calls`) vs its plain
    version on its inputs, with its bound from the same inputs (tables:
    the ids of the terrain tables, counted by the cells the queries
    touch).  On the main path (phase 3) also the reward kernel on all 33
    terms, its grid against the SM count at 4096 envs, and the noise
    kernel's checks and library time; on another task's or script's step
    (phases 8 and 10) the kernels of that step alone, the noise kernel
    bit for bit at the reset's shape.  float64_physics (default: off the
    main path) holds the decimation kernel by its float64 build, as the
    X30's step needs (phase 8); else by the float32 budget."""
    import torch
    from deep_tracking_control_tpu_torch.env import (cuda_obs, cuda_planner,
                                                     cuda_rewards)
    from deep_tracking_control_tpu_torch.env import rewards as rew_mod
    from deep_tracking_control_tpu_torch.ops import cuda_rng
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    results = {}
    # kernel -> (bytes, its plain version to count operations on, or None,
    # and the operations counted apart: the generator's)
    work = {}

    if "decimation_step" in calls:
        # K1: one policy step of physics.  Budget 1e-4: FMA contraction and
        # rsqrtf in the kernel round differently from the plain op chain, and
        # four substeps of stiff contact carry the difference.
        args, kwargs = calls["decimation_step"]
        kw = {k: v for k, v in kwargs.items() if k != "consts"}
        phys, anchors, info = cuda_substep.decimation_step(*args, **kwargs)
        pphys, panchors, pinfo = cuda_substep.decimation_step_plain(*args, **kw)
        # contact forces come from 12 kN/m springs: 1e-6 m is 1e-2 N
        outs = [(k, phys[k], pphys[k], 1e-4) for k in phys] + [
            ("anchors", anchors, panchors, 1e-4)] + [
            (k, info[k], pinfo[k], 1e-2 if k == "contact_forces" else 1e-4)
            for k in ("foot_pos", "foot_vel", "thigh_pos", "body_pts",
                      "torques", "contact_forces")]
        if float64_physics is None:
            float64_physics = not main_path
        if not float64_physics:
            for k, got, want, atol in outs:
                check_close(f"decimation_step {k}", got, want, atol, 1e-4)
            note = ""
        else:
            # the X30's step is not resolved to the budget by float32 (its
            # joint velocities part from a float64 run by more, in the plain
            # version as in the JAX package's kernel): the kernel's source
            # built in float64 is held to the plain version in float64
            # element by element, and the float32 build's rounding to the
            # plain version's (check_float_build)
            wide = [a.double() if i != 18 and isinstance(a, torch.Tensor)
                    and a.dtype == torch.float32 else a
                    for i, a in enumerate(args)]
            wide[6] = {k: v.double() for k, v in args[6].items()}
            k64 = cuda_substep.decimation_step(*wide, **kwargs)
            p64 = plain_float64(cuda_substep.decimation_step_plain, args, kw)

            def flat(out):
                return {**out[0], "anchors": out[1], **out[2]}
            k64, p64 = flat(k64), flat(p64)
            beyond = off_kernel = off_plain = 0
            for k, got, want, atol in outs:
                check_close(f"decimation_step {k} (float64 build)", k64[k],
                            p64[k], atol, 1e-4)
                counts = check_float_build(
                    f"decimation_step {k}", got, k64[k], want, p64[k], atol,
                    1e-4)
                beyond, off_kernel, off_plain = (
                    x + y for x, y in zip((beyond, off_kernel, off_plain),
                                          counts))
            err64 = max_err([(k64[k], p64[k]) for k in k64])
            note = (f"; the float64 builds within it everywhere, max abs "
                    f"err {err64:.3e}; the float32 kernel beyond it of the "
                    f"plain version at {beyond} elements, of its float64 "
                    f"build at {off_kernel}, the plain version of its "
                    f"float64 run at {off_plain}")
        err = max_err([(phys[k], pphys[k]) for k in phys]
                      + [(anchors, panchors)])
        # bytes: the arguments and results, and per env the 4 raw cells under
        # each of the 4 feet in each substep
        dec, n = args[3], args[6]["pos"].shape[-1]
        work["decimation_step"] = (
            tensor_bytes((args, kwargs), tables) + n * 4 * dec * 4 * 4,
            tensor_bytes((phys, anchors, info)),
            lambda a=args, k=kw: cuda_substep.decimation_step_plain(*a, **k), 0)
        results["decimation_step"] = dict(max_abs_err=err, **timings(
            torch, "decimation_step",
            lambda: cuda_substep.decimation_step(*args, **kwargs),
            lambda: cuda_substep.decimation_step_plain(*args, **kw), 5))
        check_launch("decimation_step", results["decimation_step"]["launch"],
                     *cuda_substep.launch_shape(n)[:2])
        say(phase, f"decimation_step vs plain: max abs err {err:.3e} "
                   f"(budget 1e-4 + 1e-4 rel; contact forces 1e-2 N{note}); "
                   f"{shape_text(cuda_substep.launch_shape(n))}, device "
                   f"{results['decimation_step']['ms']:.4f} ms a call")

    if "sample_all" in calls:
        # K2: nearest samples are bf16 cells (exact); bilinear 1e-5, slope 1e-4
        args, _ = calls["sample_all"]
        h, gx, gy = cuda_sampler.sample_all(*args)
        ph, pgx, pgy = cuda_sampler.sample_all_plain(*args)
        near = cuda_sampler.Q_MIN3 + cuda_sampler.Q_MAX10
        if not torch.equal(h[:, :near], ph[:, :near]):
            raise AssertionError("sample_all: nearest samples differ")
        check_close("sample_all bilinear", h[:, near:], ph[:, near:], 1e-5, 0.0)
        check_close("sample_all gx", gx, pgx, 1e-4, 0.0)
        check_close("sample_all gy", gy, pgy, 1e-4, 0.0)
        err = max_err([(h, ph), (gx, pgx), (gy, pgy)])
        # bytes: the arguments and results, and per env one bf16 cell for each
        # nearest sample and 4 float32 cells for each bilinear one
        n = h.shape[0]
        work["sample_all"] = (
            tensor_bytes(args, tables)
            + n * (near * 2 + cuda_sampler.Q_BIL * 4 * 4),
            tensor_bytes((h, gx, gy)),
            lambda a=args: cuda_sampler.sample_all_plain(*a), 0)
        results["sample_all"] = dict(max_abs_err=err, **timings(
            torch, "sample_all", lambda: cuda_sampler.sample_all(*args),
            lambda: cuda_sampler.sample_all_plain(*args)))
        # the card path queues the kernel and nothing else (the patch
        # coordinates are made inside it)
        if results["sample_all"]["others"]:
            raise AssertionError(f"sample_all queues more than its kernel: "
                                 f"{results['sample_all']['others']}")
        blocks, threads, _ = cuda_sampler.launch_shape(n)
        check_launch("sample_all", results["sample_all"]["launch"], blocks,
                     threads)
        say(phase, f"sample_all vs plain: nearest exact, max abs err {err:.3e} "
                   f"(budget 1e-5 heights, 1e-4 slopes); one device op a call; "
                   f"launch shape {blocks} blocks x {threads} threads, 4 queries a "
                   f"thread, device {results['sample_all']['ms']:.4f} ms a call")

    if "plan_footholds" in calls:
        # K3: selections may differ in <= 2% of envs, and only at near-ties
        (scal, heights, stat, ny), _ = calls["plan_footholds"]
        got = cuda_planner.select_footholds(scal, heights, stat, ny)
        want = cuda_planner.plan_plain(scal, heights, stat, ny)
        differ = check_planner(got, want, scal, heights, stat, ny)
        frac = float(differ.float().mean())
        err = max_err([(got[~differ], want[~differ])]) if (~differ).any() else 0.0
        work["plan_footholds"] = (
            tensor_bytes((scal, heights, stat)), tensor_bytes(got),
            lambda: cuda_planner.plan_plain(scal, heights, stat, ny), 0)
        results["plan_footholds"] = dict(max_abs_err=err, **timings(
            torch, "plan_footholds",
            lambda: cuda_planner.select_footholds(scal, heights, stat, ny),
            lambda: cuda_planner.plan_plain(scal, heights, stat, ny)))
        check_launch("plan_footholds", results["plan_footholds"]["launch"],
                     *cuda_planner.launch_shape(got.shape[0])[:2])
        say(phase, f"plan_footholds vs plain: {frac:.3%} of envs differ "
                   f"(budget 2%, "
                   f"near-ties only); max abs err elsewhere {err:.3e}; "
                   f"{shape_text(cuda_planner.launch_shape(got.shape[0]))}, device "
                   f"{results['plan_footholds']['ms']:.4f} ms a call")

    # K6: the reward stack on the real step, then on random inputs that
    # switch on all 33 terms, with and without the positive clip
    args, _ = calls["compute_rewards"]
    err = check_rewards("compute_rewards", args)
    names = list(rew_mod.REWARD_FUNCTIONS)
    scales = {n: 0.01 * (i + 1) * (-1) ** i for i, n in enumerate(names)}
    g = torch.Generator("cuda").manual_seed(11)
    for only_positive in ((False, True) if main_path else ()):
        ctx = synthetic_ctx(NUM_ENVS, 3 + only_positive, "cuda")
        sums = torch.randn((len(names) + 1, NUM_ENVS), device="cuda",
                           generator=g)
        e33 = check_rewards(
            f"compute_rewards (33 terms, only_positive={only_positive})",
            (names, scales, ctx, only_positive, -0.5, names + ["termination"],
             sums))
        say(phase, f"compute_rewards vs plain, all 33 terms at {NUM_ENVS} envs, "
                   f"only_positive={only_positive}: max abs err {e33:.3e}")
    *head, sums = args
    scratch = sums.clone()            # the timed calls add to it
    rew, upd = cuda_rewards.compute_rewards_fused(*head, scratch.clone())
    # bytes: the step quantities (the height scan among them, read by the
    # kernel's plane fit), the sums read and written, the outputs
    work["compute_rewards"] = (
        tensor_bytes(args), tensor_bytes((sums, rew, upd)),
        lambda: cuda_rewards.rewards_plain(*head, scratch), 0)
    results["compute_rewards"] = dict(max_abs_err=err, **timings(
        torch, "compute_rewards",
        lambda: cuda_rewards.compute_rewards_fused(*head, scratch),
        lambda: cuda_rewards.rewards_plain(*head, scratch)))
    # a team of lanes an env: the grid covers every SM; the plane fit is
    # made inside the kernel, so the call queues the kernel alone
    if results["compute_rewards"]["others"]:
        raise AssertionError(f"compute_rewards queues more than its kernel: "
                             f"{results['compute_rewards']['others']}")
    blocks, threads, envs = cuda_rewards.launch_shape(rew.shape[0])
    check_launch("compute_rewards", results["compute_rewards"]["launch"],
                 blocks, threads)
    # at 4096 envs the grid covers the SMs (2048 envs fill 128 of 132)
    if main_path and (blocks < torch.cuda.get_device_properties(0)
                      .multi_processor_count):
        raise AssertionError(f"compute_rewards: {blocks} blocks leave SMs "
                             f"idle")
    say(phase, f"compute_rewards vs plain on the step: {len(head[0])} terms + "
               f"termination (only_positive={head[3]}), max abs err "
               f"{err:.3e} (budget 1e-5 + 2e-5 rel; "
               f"feet_air_time 1e-7 + 1e-6 rel, pitch_est 1e-6 + 1e-5 rel, the "
               f"stumble ring exact); {shape_text((blocks, threads, envs))}, "
               f"device {results['compute_rewards']['ms']:.4f} ms a call")

    # K7: against the plain version fed the noise kernel's draws for the
    # same seed (1e-6); the plain version's own draws must be those draws
    args, kwargs = calls["compute_observations"]
    if any(v is not None for v in kwargs.values()):
        raise AssertionError("the env handed noise arrays to the obs kernel")
    err, got, draws = check_observations(args)
    N, H = args[10].shape
    num_obs = args[14].shape[0]
    drawn = N * H + (N * num_obs if args[0].noise.add_noise else 0)
    work["compute_observations"] = (
        tensor_bytes(args), tensor_bytes(got),
        lambda: cuda_obs.observations_plain(*args, **draws),
        PHILOX_OPS * drawn)
    results["compute_observations"] = dict(max_abs_err=err, **timings(
        torch, "compute_observations",
        lambda: cuda_obs.compute_observations_fused(*args),
        lambda: cuda_obs.observations_plain(*args)))
    # the call queues the kernel alone: the draws are made inside it
    if results["compute_observations"]["others"]:
        raise AssertionError(f"compute_observations queues more than its "
                             f"kernel: {results['compute_observations']['others']}")
    # its launch as the timing session recorded it, held to the shape the
    # wrapper states; the build log's ptxas lines for the text alone
    launch = results["compute_observations"]["launch"]
    shape = cuda_obs.launch_shape(N)
    check_launch("compute_observations", launch, *shape[:2])
    usage = ptxas_usage(SYMBOLS["compute_observations"])
    say(phase, f"compute_observations vs plain fed the noise kernel's draws "
               f"({num_obs}-dim obs, {N} envs): max "
               f"abs err {err:.3e} (budget 1e-6); the plain draws equal them; "
               f"recorded launch {launch}, the wrapper's {shape_text(shape)}; "
               f"build log's ptxas (registers, stack bytes) "
               f"{sorted(usage.values()) or 'not in this build log'}; device "
               f"{results['compute_observations']['ms']:.4f} ms a call")

    if main_path:
        # K8: bit for bit at the obs shapes and at the reset's; moments; seeds
        (rseed, rshape), _ = calls["uniform_pm1"]
        g = torch.Generator("cuda").manual_seed(12)
        seed, other = cuda_rng.draw_seed(g, "cuda"), cuda_rng.draw_seed(g, "cuda")
        for shape, stream in (((NUM_ENVS, H), 0), ((NUM_ENVS, num_obs), 1),
                              (tuple(rshape), 0)):
            u = cuda_rng.uniform_pm1(seed, shape, stream)
            if not torch.equal(u, cuda_rng.uniform_pm1_plain(seed, shape, stream)):
                raise AssertionError(f"uniform_pm1 {shape}: differs from plain")
        u = cuda_rng.uniform_pm1(seed, (NUM_ENVS, H)).double()
        mean, var = float(u.mean()), float(u.var())
        lo, hi = float(u.min()), float(u.max())
        if not (abs(mean) < 0.01 and abs(var - 1 / 3) < 0.01 and lo >= -1.0
                and hi < 1.0):
            raise AssertionError(f"uniform_pm1 moments: mean {mean} var {var} "
                                 f"min {lo} max {hi}")
        if torch.equal(cuda_rng.uniform_pm1(other, (NUM_ENVS, H)), u.float()):
            raise AssertionError("uniform_pm1: two seeds drew the same values")
        say(phase, f"uniform_pm1 vs plain: bit-exact at {(NUM_ENVS, H)}, "
                   f"{(NUM_ENVS, num_obs)} and the reset's {tuple(rshape)}; over "
                   f"{NUM_ENVS}x{H}: mean {mean:.3e}, variance {var:.6f} (1/3 "
                   f"+- 0.01), min {lo}, max {hi}; another seed differs")
        res = {}
        for shape in ((NUM_ENVS, H), tuple(rshape)):
            def library(shape=shape):
                return torch.empty(shape, device="cuda").uniform_(-1.0, 1.0,
                                                                  generator=g)
            res[shape] = dict(
                max_abs_err=0.0, library_ms=device_ms(torch, library),
                library_wall_ms=wall_ms(torch, library), **timings(
                    torch, "uniform_pm1",
                    lambda s=shape: cuda_rng.uniform_pm1(rseed, s),
                    lambda s=shape: cuda_rng.uniform_pm1_plain(rseed, s)))
            numel = shape[0] * shape[1]
            res[shape].update(bound(16, numel * 4, PHILOX_OPS * numel))
            r = res[shape]
            say(phase, f"uniform_pm1 at {shape}: device time per call, mean of "
                       f"{REPEATS}: kernel call {r['ms']:.4f} ms (its CUDA kernel "
                       f"alone {r['kernel_ms']:.4f} ms), plain {r['plain_ms']:.4f}"
                       f" ms, uniform_ {r['library_ms']:.4f} ms; stream time: kernel "
                       f"{r['wall_ms']:.4f} ms, plain {r['plain_wall_ms']:.4f} ms, "
                       f"uniform_ {r['library_wall_ms']:.4f} ms; bound "
                       f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
        results["uniform_pm1"] = r = res[tuple(rshape)]   # the main path's shape
        # its launch floors: an empty kernel and one that only loads the seed,
        # at the launch shape its timing session recorded
        blocks, threads = cuda_rng.launch_shape(rshape[0] * rshape[1])
        check_launch("uniform_pm1", r["launch"], blocks, threads)
        floors = launch_floors(torch, rseed, blocks, threads)
        r.update(floor_empty_ms=floors["empty"], floor_seed_ms=floors["seed_load"])
        say(phase, f"uniform_pm1 at {tuple(rshape)}: its kernel alone "
                   f"{r['kernel_ms']:.4f} ms; at its recorded launch shape ({blocks} "
                   f"blocks x {threads} threads) an empty kernel "
                   f"{floors['empty']:.4f} ms, a seed-load kernel "
                   f"{floors['seed_load']:.4f} ms: "
                   f"{r['kernel_ms'] / floors['seed_load']:.2f}x the seed-load floor")

    if not main_path and "uniform_pm1" in calls:
        # K8 at the reset's shape of this step: bit for bit
        (rseed, rshape), _ = calls["uniform_pm1"]
        if not torch.equal(cuda_rng.uniform_pm1(rseed, rshape),
                           cuda_rng.uniform_pm1_plain(rseed, rshape)):
            raise AssertionError(f"uniform_pm1 {tuple(rshape)}: differs from "
                                 f"plain")
        numel = rshape[0] * rshape[1]
        results["uniform_pm1"] = r = dict(
            max_abs_err=0.0, **bound(16, numel * 4, PHILOX_OPS * numel),
            **timings(torch, "uniform_pm1",
                      lambda: cuda_rng.uniform_pm1(rseed, rshape),
                      lambda: cuda_rng.uniform_pm1_plain(rseed, rshape)))
        check_launch("uniform_pm1", r["launch"],
                     *cuda_rng.launch_shape(numel))
        say(phase, f"uniform_pm1 vs plain: bit-exact at the reset's "
                   f"{tuple(rshape)}; device {r['ms']:.4f} ms a call")

    # operations are counted after all the timings: the counting mode
    # intercepts every op of the plain version
    for k, (read, written, plain, extra) in work.items():
        ops = count_ops(plain) + extra
        results[k].update(bound(read, written, ops))
        say(phase, f"{k}: {read} bytes read, {written} written, {ops:.0f} "
                   f"operations")
    return results


def compare_route_kernels(calls, tables, results, phase=7):
    """Phase 7: the copies (bit for bit) and the decimation kernel's window
    variant (bit for bit against the fused kernel on the same state, and
    within K1's budget of its plain version) on a route's recorded step.
    Each kernel is timed, and its bound taken, on the first route that
    runs it; `results` collects them by KERNELS name."""
    import torch
    from deep_tracking_control_tpu_torch.ops import cuda_patch
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    starts = None
    for name, plain in (("extract_patches", cuda_patch.extract_patches_plain),
                        ("extract_windows", cuda_patch.extract_windows_plain)):
        if name not in calls:
            continue
        args, kwargs = calls[name]
        fn = getattr(cuda_patch, name)
        got, want = fn(*args, **kwargs), plain(*args, **kwargs)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from its plain version")
        blocks, starts = args[0], args[1]
        say(phase, f"{name} vs plain: bit-exact, {tuple(got.shape)} from "
               f"{starts.shape[0]} starts")
        if name in results:
            continue
        # the library call: one advanced-index gather with the indices made
        b = starts[:, 1].long()[:, None]
        r = starts[:, 0].long()[:, None] + torch.arange(
            got.shape[-2], device=starts.device)
        if name == "extract_windows":
            r = r + args[2]

            def library():
                return blocks[0, b, r]
        else:
            def library():
                return blocks[:, b, r]
        # bytes: each table cell the copies touch read once (neighbouring
        # envs' slabs overlap), the output written once, the starts
        T = blocks.shape[0] if name == "extract_patches" else 1
        touched = int(torch.unique(b * blocks.shape[2] + r).numel())
        read = (T * touched * blocks.shape[3] * blocks.element_size()
                + tensor_bytes(starts))
        say(phase, f"{name}: {T} x {touched} distinct table rows touched, "
               f"{read} bytes read, {tensor_bytes(got)} written")
        results[name] = dict(
            max_abs_err=0.0, **bound(read, tensor_bytes(got), 0),
            **timings(torch, name, lambda: fn(*args, **kwargs),
                      lambda: plain(*args, **kwargs)),
            library_ms=device_ms(torch, library),
            library_wall_ms=wall_ms(torch, library))

    if "decimation_step" not in calls:
        return
    args, kwargs = calls["decimation_step"]
    window = kwargs.get("window")
    if window is None or starts is None:
        raise AssertionError("the route's decimation step read no window")
    got = cuda_substep.decimation_step(*args, **kwargs)
    fused = cuda_substep.decimation_step(*args[:18], blocks, starts,
                                         consts=kwargs["consts"])
    kw = {k: v for k, v in kwargs.items() if k != "consts"}
    plain = cuda_substep.decimation_step_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for (k, a), (_, f), (_, p) in zip(*(sorted(
            {**ph, "anchors": an, **info}.items())
            for ph, an, info in (got, fused, plain))):
        if not torch.equal(a, f):
            raise AssertionError(f"decimation_step_window {k}: differs from "
                                 f"the fused kernel")
        # contact forces come from 12 kN/m springs: 1e-6 m is 1e-2 N
        check_close(f"decimation_step_window {k}", a, p,
                    1e-2 if k == "contact_forces" else 1e-4, 1e-4)
        if k != "contact_forces":
            err = max(err, float((a - p).abs().max()))
    say(phase, f"decimation_step_window: bit-exact with the fused kernel on the "
           f"same state; vs plain max abs err {err:.3e} (budget 1e-4 + 1e-4 "
           f"rel; contact forces 1e-2 N)")
    if "decimation_step_window" in results:
        return
    # bytes: as the fused kernel's, the window counted by the cells read
    dec, n = args[3], args[6]["pos"].shape[-1]
    read = (tensor_bytes((args, kwargs), tables | {id(window)})
            + n * 4 * dec * 4 * 4)
    ops = count_ops(lambda: cuda_substep.decimation_step_plain(*args, **kw))
    results["decimation_step_window"] = r = dict(
        max_abs_err=err, **bound(read, tensor_bytes(got), ops),
        **timings(torch, "decimation_step_window",
                  lambda: cuda_substep.decimation_step(*args, **kwargs),
                  lambda: cuda_substep.decimation_step_plain(*args, **kw), 5))
    say(phase, f"decimation_step_window: {shape_text(cuda_substep.launch_shape(n))}"
           f", device {r['ms']:.4f} ms a call")


def check_rows(name, rows):
    """Raise unless every stat of every learn iteration is finite (the
    tracer's "trace" aside)."""
    for i, row in enumerate(rows):
        bad = [k for k, v in row.items()
               if k != "trace" and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{name} iteration {i}: {bad} not finite")


def route_collect(name, runner, kernels, card):
    """One warm-up collect and one timed collect on a route: finite batch,
    the route's launch counts, and under strict parity the float32
    storage.  Returns the launch counts."""
    import torch
    runner.collect()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    batch, aux = runner.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    T = runner.cfg.runner.num_steps_per_env
    for k, v in batch.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"{name} collect: batch[{k}] not finite")
    want = expected_launches(kernels, T)
    if counts != want:
        raise AssertionError(f"{name} collect: launches {counts}, expected "
                             f"{want}")
    strict = name == "DTC_STRICT_PARITY=1"
    if batch["privileged_obs"].dtype != (torch.float32 if strict
                                         else torch.bfloat16):
        raise AssertionError(f"{name}: privileged obs stored as "
                             f"{batch['privileged_obs'].dtype}")
    rate = T * runner.env.num_envs / wall
    say(7, f"{name}: collect of {T} steps x {runner.env.num_envs} envs after "
           f"one warm-up collect: {wall:.3f} s, {rate:.1f} env-steps/s; "
           f"launches {counts}; privileged obs stored as "
           f"{batch['privileged_obs'].dtype} ({card})")
    return counts


def strict_learn(runner, card, iters=2):
    """learn(iters) under strict parity: the reference's update (float32
    storage, sequential VAE-then-policy steps, a per-row gather, G=1), its
    launch counts, finite stats and moving params."""
    import torch
    from deep_tracking_control_tpu_torch.agent.ppo import shuffle_layout
    alg = runner.ppo.alg
    T, N = runner.cfg.runner.num_steps_per_env, runner.env.num_envs
    G = shuffle_layout(alg, T, N, runner.ppo.world)[3]
    if (alg.fused_joint_step, alg.minibatch_perm_granule, G) != (False, 1, 1):
        raise AssertionError(f"strict parity: fused_joint_step "
                             f"{alg.fused_joint_step}, granule "
                             f"{alg.minibatch_perm_granule}, G {G}")
    before = [p.detach().clone() for p in runner.net.parameters()]
    zero_launches()
    t0 = time.perf_counter()
    rows = runner.learn(iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = expected_launches(ROUTES["DTC_STRICT_PARITY=1"][1], iters * T,
                             iters)
    if counts != want:
        raise AssertionError(f"strict learn({iters}): launches {counts}, "
                             f"expected {want}")
    check_rows("strict learn", rows)
    if all(torch.equal(a, b) for a, b in zip(before, runner.net.parameters())):
        raise AssertionError("strict learn: the params did not move")
    coll = sum(r["collection_time"] for r in rows)
    learn = sum(r["learning_time"] for r in rows)
    say(7, f"DTC_STRICT_PARITY=1: learn({iters}) at {N} envs: "
           f"{iters * T * N / wall:.1f} train-iteration env-steps/s "
           f"({wall:.3f} s; update share {learn / (coll + learn):.3f}), "
           f"G={G}, launches {counts} ({card})")


def small_reference_check(registry, LeggedEnv, device="cuda",
                          name="lite3_dtc", transform=None):
    """One step of a 16-env task (lite3_dtc unless `name` says another
    registered task; `transform` edits its config) on the card against
    the same step on the CPU (plain versions), from the same state, lag
    draw and noise seed.
    A reset env respawns from its side's own draws and is left out; so is
    an env whose planner picked another cell at a near-tie (its foothold
    obs and foothold reward differ by design).  Physics 1e-4 + 1e-4 rel,
    heights 1e-5; rewards, episode sums, obs and privileged obs carry the
    physics' difference through scaled sums: 1e-3 + 1e-3 rel."""
    import dataclasses
    import torch
    task, _ = registry.get_cfgs(name)
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=16),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    if transform is not None:
        task = transform(task)
    genv = LeggedEnv(task, device=device)
    cenv = LeggedEnv(task, device="cpu")
    na = cenv.num_actions
    cgen = torch.Generator().manual_seed(5)
    cparams, cstate = cenv.init(cgen)
    for _ in range(2):
        cstate, _ = cenv.step(cparams, cstate, torch.zeros(16, na), cgen)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.to(dev).clone()
        return tree
    gstate = to(cstate, genv.device)
    gparams = dict(to({k: v for k, v in cparams.items() if k != "terrain"},
                      genv.device), terrain=genv.patch_src)
    draws = dict(lag=torch.tensor([2, 1, 3, 4] * 2)[:task.control.decimation],
                 noise_seed=torch.tensor([1234567, 7654321]))
    actions = 0.3 * torch.randn((16, na), generator=cgen)
    cs, co = cenv.step(cparams, cstate, actions, cgen, draws=draws)
    gs, go = genv.step(gparams, gstate, actions.to(genv.device),
                       torch.Generator(genv.device).manual_seed(0),
                       draws=to(draws, genv.device))
    if not torch.equal(go["done"].cpu(), co["done"]):
        raise AssertionError("small step: done flags differ")
    keep = ~co["done"]            # a reset env respawns from its own draws
    err = 0.0
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        got, want = gs["phys"][k].cpu()[:, keep], cs["phys"][k][:, keep]
        check_close(f"small step {k}", got, want, 1e-4, 1e-4)
        err = max(err, float((got - want).abs().max()))
    check_close("small step measured_heights", gs["measured_heights"].cpu(),
                cs["measured_heights"], 1e-5, 0.0)
    same = keep & (gs["foothold_obs"].cpu() == cs["foothold_obs"]).all(dim=1)
    if int(same.sum()) < 12:
        raise AssertionError(f"small step: only {int(same.sum())} of 16 envs "
                             f"comparable")
    check_close("small step rew", go["rew"].cpu()[same], co["rew"][same],
                1e-3, 1e-3)
    check_close("small step episode_sums", gs["episode_sums"].cpu()[:, same],
                cs["episode_sums"][:, same], 1e-3, 1e-3)
    for k in ("obs", "privileged_obs"):
        check_close(f"small step {k}", go[k].cpu()[same], co[k][same],
                    1e-3, 1e-3)
    return err, int(same.sum())


# the routes off the decimation kernel (phase 12): the patch copy beside
# the reward, obs and noise kernels; the plain decimation loop over
# sim_step, the plain samplers and the plain planner
PLAIN_ROUTE = ("extract_patches",)
# steps a phase-12 profile covers: a profiler session's events take
# ~0.1 ms each to sum on the host, and a collect of these routes queues
# ~300,000 device ops
PROFILED_STEPS = 4


def profiled_steps(runner, steps=PROFILED_STEPS):
    """`steps` steps of the runner's acting and env step, as collect takes
    them, in one profiler session (`device_busy`): (wall ms, device ms,
    device ops), each a step.  The runner's env state moves on; its
    episode log does not see these steps."""
    params, gen = runner.env_params, runner.generator
    state = runner.env_state

    def run():
        nonlocal state
        for _ in range(steps):
            a = runner.ppo.act(state["obs"], state["obs_history"],
                               state["privileged_obs"], state["base_vel"],
                               gen)
            state, _ = runner.env.step(params, state, a["actions"], gen)
    wall, busy, ops, _, _ = device_busy(run)
    runner.env_state = state
    if not ops:
        raise AssertionError("the profiler saw no device time")
    return wall / steps, busy / steps, ops / steps


def plain_route_rates(label, runner, card, warm_up=True):
    """Phase 12: on a runner whose env takes the plain decimation loop, one
    warm-up collect (unless the caller ran it), a timed collect,
    PROFILED_STEPS profiled steps (device ms, device ops and busy share a
    step) and learn(1), every launch counted from zero and held to
    PLAIN_ROUTE: K4, K6, K7 and K8 once a step, K9 once an update, no K1,
    K2 or K3.  Returns the timed collect's launch counts."""
    import torch
    env = runner.env
    if env._kernel_physics or env._consts is not None:
        raise AssertionError(f"{label}: the env took the decimation kernel")
    T, N = runner.cfg.runner.num_steps_per_env, env.num_envs
    if warm_up:
        runner.collect()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    batch, _ = runner.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != expected_launches(PLAIN_ROUTE, T):
        raise AssertionError(f"{label} collect: launches {counts}, expected "
                             f"{expected_launches(PLAIN_ROUTE, T)}")
    for k, v in batch.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"{label} collect: batch[{k}] not finite")
    if batch["obs"].shape != (T, N, env.num_obs):
        raise AssertionError(f"{label}: obs {tuple(batch['obs'].shape)}")
    del batch
    pwall, busy, ops = profiled_steps(runner)
    zero_launches()
    t0 = time.perf_counter()
    rows = runner.learn(1)
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    learn_counts = launch_counts()
    if learn_counts != expected_launches(PLAIN_ROUTE, T, 1):
        raise AssertionError(f"{label} learn(1): launches {learn_counts}")
    check_rows(f"{label} learn", rows)
    share = rows[0]["learning_time"] / (rows[0]["collection_time"]
                                        + rows[0]["learning_time"])
    say(12, f"{label}: collect of {T} steps x {N} envs after one warm-up "
            f"collect: {wall:.3f} s, {T * N / wall:.1f} env-steps/s; "
            f"launches {counts}; {PROFILED_STEPS} profiled steps (act and "
            f"env step), a step: wall {pwall:.1f} ms, device {busy:.2f} ms "
            f"(busy share {busy / pwall:.3f}), {ops:.0f} device ops; "
            f"learn(1): {lwall:.3f} s, {T * N / lwall:.1f} "
            f"train-iteration env-steps/s (update share {share:.3f}), "
            f"launches {learn_counts} ({card})")
    return counts


def substeps_route(registry, LeggedEnv, OnPolicyRunner, card):
    """Phase 12 (a): lite3_dtc at its registry width with two physics
    substeps a sim step, which the decimation kernel does not take: the
    plain decimation loop over sim_step (the leg-batched FK/ABA, every
    contact point at every substep).  Its rates and launches, (c) on its
    state after the warm-up collect, and a 16-env step on the card
    against the CPU."""
    task, train = registry.get_cfgs("lite3_dtc")

    def two_substeps(t):
        return dataclasses.replace(t, sim=dataclasses.replace(t.sim,
                                                              substeps=2))
    t0 = time.perf_counter()
    env = LeggedEnv(two_substeps(task), device="cuda")
    runner = OnPolicyRunner(env, train)
    if env.terrain.backend != "native":
        raise AssertionError(f"terrain backend {env.terrain.backend!r}")
    say(12, f"(a) lite3_dtc at substeps=2: {env.num_envs} envs, "
            f"{env.num_obs}-dim obs; set up in "
            f"{time.perf_counter() - t0:.1f} s")
    # the warm-up collect, then (c) on its state, ahead of the profiled
    # steps: after a profiler session of many device ops the next sessions
    # may record nothing for seconds
    runner.collect()
    engines_on_card(runner, card)
    plain_route_rates("(a) lite3_dtc, substeps=2", runner, card,
                      warm_up=False)
    err, same = small_reference_check(registry, LeggedEnv,
                                      transform=two_substeps)
    say(12, f"(a) 16-env step at substeps=2 on the card vs on the CPU: "
            f"physics max abs err {err:.3e} (budget 1e-4); rewards, sums, "
            f"obs and privileged obs within 1e-3 + 1e-3 rel on {same} of 16 "
            f"envs")


def three_leg_route(registry, LeggedEnv, OnPolicyRunner, card, root):
    """Phase 12 (b): a robot that is not a 4x3 quadruped, through the
    entry points a user takes: its URDF (`three_leg_urdf`, written under
    `root`) on lite3_rough, registered with `registry.register`, at the
    registry width.  The generic FK/ABA in the plain decimation loop; K4,
    K6, K7 and K8 against their plain versions on a recorded step (rows
    "kernel (three-leg)"), the rates and launches, and a 16-env step on
    the card against the CPU.  Returns the kernel rows."""
    from deep_tracking_control_tpu_torch.env import cuda_obs, cuda_rewards
    from deep_tracking_control_tpu_torch.ops import cuda_patch, cuda_rng
    from deep_tracking_control_tpu_torch.physics import quadruped
    urdf = three_leg_urdf(os.path.join(root, "three_leg.urdf"))
    registry.register("three_leg_rough",
                      lambda: three_leg_task(registry, urdf))
    task, train = registry.get_cfgs("three_leg_rough")
    t0 = time.perf_counter()
    env = LeggedEnv(task, device="cuda")
    runner = OnPolicyRunner(env, train)
    m = env.model
    if (quadruped.quad_layout(m) is not None or m.nq != 9
            or len(m.foot_body_index) != 3):
        raise AssertionError(f"three-leg robot: nb {m.nb}, nq {m.nq}, "
                             f"{len(m.foot_body_index)} feet")
    say(12, f"(b) three-leg lite3_rough: {env.num_envs} envs, {m.nb} dynamic "
            f"bodies, {m.nq} joints, {len(m.foot_body_index)} feet, "
            f"{env.num_obs}-dim obs, {env.num_actions} actions; set up in "
            f"{time.perf_counter() - t0:.1f} s")
    slots = ((cuda_patch, "extract_patches", "extract_patches"),
             (cuda_rewards, "compute_rewards_fused", "compute_rewards"),
             (cuda_obs, "compute_observations_fused", "compute_observations"),
             (cuda_rng, "uniform_pm1", "uniform_pm1"))
    calls, runner.env_state = record_kernel_inputs(
        env, runner.env_params, runner.env_state, runner.generator, steps=2,
        slots=slots)
    if set(calls) != {s[2] for s in slots}:
        raise AssertionError(f"three-leg step ran {sorted(calls)}")
    tables = {id(env.patch_src.blocks), id(env.patch_src.blocks16)}
    results = {}
    compare_route_kernels({"extract_patches": calls["extract_patches"]},
                          tables, results, phase=12)
    results.update(compare_kernels(calls, tables, phase=12, main_path=False))
    del calls
    counts = plain_route_rates("(b) three-leg lite3_rough", runner, card)
    err, same = small_reference_check(registry, LeggedEnv,
                                      name="three_leg_rough")
    say(12, f"(b) 16-env three-leg step on the card vs on the CPU: physics "
            f"max abs err {err:.3e} (budget 1e-4); rewards, sums, obs and "
            f"privileged obs within 1e-3 + 1e-3 rel on {same} of 16 envs")
    del runner, env
    return {f"{k} (three-leg)": dict(r, launches=counts[k])
            for k, r in results.items()}


@contextlib.contextmanager
def generic_engine():
    """sim_step through the generic FK/ABA for every robot: the port's
    quadruped detection finds no layout for the `with` block."""
    from deep_tracking_control_tpu_torch.physics import quadruped
    saved = quadruped.quad_layout
    quadruped.quad_layout = lambda model: None
    try:
        yield
    finally:
        quadruped.quad_layout = saved


def check_engines(got, want):
    """One sim_step of the generic FK/ABA (`got`) against the leg-batched
    one (`want`), each (state, anchors, info) from the same state: 1e-4 +
    1e-4 rel on the state, anchors, foot positions and velocities; contact
    forces 1e-2 N + 1e-4 rel (12 kN/m springs: 1e-6 m is 1e-2 N).
    Returns the max abs err over the state and anchors."""
    (gs, ga, gi), (ws, wa, wi) = got, want
    pairs = [(k, gs[k], ws[k]) for k in ws] + [("anchors", ga, wa)] + [
        (k, gi[k], wi[k]) for k in ("foot_pos", "foot_vel")]
    for k, a, b in pairs:
        check_close(f"generic vs leg-batched {k}", a, b, 1e-4, 1e-4)
    check_close("generic vs leg-batched contact_forces",
                gi["contact_forces"], wi["contact_forces"], 1e-2, 1e-4)
    if float(wi["contact_forces"][:, 2].abs().sum()) <= 1.0:
        raise AssertionError("generic vs leg-batched: no contact")
    return max_err([(gs[k], ws[k]) for k in ws] + [(ga, wa)])


def engines_on_card(runner, card, repeats=5):
    """Phase 12 (c): one sim_step of the generic FK/ABA against one of the
    leg-batched FK/ABA at the width of `runner`'s Lite3 env, from its
    state after (a)'s warm-up collect (the last torques held, its terrain
    patches, one substep): `check_engines`, and the device ms, device ops
    and stream ms of a call of each."""
    import torch
    from deep_tracking_control_tpu_torch.physics import sim as psim
    from deep_tracking_control_tpu_torch.terrain import patch as tpatch
    env, params, state = runner.env, runner.env_params, runner.env_state
    phys = {k: v.contiguous() for k, v in state["phys"].items()}
    src = params["terrain"]
    starts, origin = tpatch.patch_starts(src, phys["pos"].T[:, :2])
    patches = tpatch.extract(src, starts)
    hs = src.horizontal_scale

    def terrain_fn(x, y):
        h, dx, dy, hmx = tpatch.sample_bilinear_slope(patches[0], origin, hs,
                                                      x.T, y.T)
        return h.T, dx.T, dy.T, hmx.T
    sim = dataclasses.replace(env.cfg.sim, substeps=1)
    args = (env.model, env.geom, sim, params["inertias"], phys,
            state["anchors"].contiguous(), state["torques"].T.contiguous(),
            terrain_fn, params["friction"], params["restitution"])

    def step():
        return psim.sim_step(*args)
    rows = {}
    for label in ("leg-batched", "generic"):
        with (generic_engine() if label == "generic"
              else contextlib.nullcontext()):
            out = step()
            events, seen = device_profile(torch, step, repeats)
            rows[label] = dict(
                out=out, ms=sum(us for _, us, _ in events) / 1e3 / seen,
                ops=sum(c for _, _, c in events) / seen,
                wall=wall_ms(torch, step, repeats))
    err = check_engines(rows["generic"]["out"], rows["leg-batched"]["out"])
    g, b = rows["generic"], rows["leg-batched"]
    say(12, f"(c) one sim_step at {env.num_envs} envs of Lite3, generic vs "
            f"leg-batched FK/ABA from the same state: max abs err "
            f"{err:.3e} (budget 1e-4 + 1e-4 rel; contact forces 1e-2 N); "
            f"device ms a call {g['ms']:.3f} vs {b['ms']:.3f}, device ops "
            f"{g['ops']:.0f} vs {b['ops']:.0f}, stream ms {g['wall']:.3f} vs "
            f"{b['wall']:.3f} ({card})")


def check_gather_bit_exact(ppo, batch, gen):
    """K9 against its plain version on a collect's batch, as the update
    shuffles it (S=1 on one card: the flat batch, one group permutation):
    bit for bit.  Returns (the flat fields, the permutation, G)."""
    import torch
    from deep_tracking_control_tpu_torch.agent.ppo import shuffle_layout
    from deep_tracking_control_tpu_torch.ops import cuda_gather
    T, N = batch["values"].shape
    S, _, _, G = shuffle_layout(ppo.alg, T, N, ppo.world)
    if S != 1:
        raise AssertionError(f"one card should shuffle in one stratum, not {S}")
    flat = {k: x.reshape((T * N,) + x.shape[2:]) for k, x in batch.items()}
    perm = torch.randperm(T * N // G, generator=gen, device=gen.device)
    got = cuda_gather.permute_groups(flat, perm, G)
    want = cuda_gather.permute_groups_plain(flat, perm, G)
    for k in flat:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"permute_groups: field {k} differs")
    return flat, perm, G


def compare_gather(ppo, batch, gen):
    """K9 against its plain version on the batch of a real collect, as the
    update shuffles it (S=1: the flat batch, one group permutation):
    bit-exact.  Also times torch.index_select on the (C, G*w) view of each
    field (the library call computing the same function), summed over the
    fields."""
    import torch
    from deep_tracking_control_tpu_torch.ops import cuda_gather
    T, N = batch["values"].shape
    flat, perm, G = check_gather_bit_exact(ppo, batch, gen)
    C = perm.shape[0]
    views = [x.reshape(C, -1) for x in flat.values()]

    def library():
        for v in views:
            torch.index_select(v, 0, perm)
    nbytes = 2 * tensor_bytes(flat) + tensor_bytes(perm)
    res = dict(max_abs_err=0.0,
               **bound(tensor_bytes(flat) + tensor_bytes(perm),
                       tensor_bytes(flat), 0),
               **timings(torch, "permute_groups",
                         lambda: cuda_gather.permute_groups(flat, perm, G),
                         lambda: cuda_gather.permute_groups_plain(flat, perm, G)),
               library_ms=device_ms(torch, library),
               library_wall_ms=wall_ms(torch, library))
    say(4, f"permute_groups vs plain: {len(flat)} fields, {T * N} rows of "
           f"{tensor_bytes(flat) // (T * N)} bytes, G={G}: bit-exact; "
           f"{nbytes / 1e6:.1f} MB moved")
    return res


def train_path(runner, card):
    """Phase 5: learn(ITERS) after a warm-up learn(1), every launch counted
    from zero; stats finite, params moved, the learning rate in its band.
    Returns the launch counts."""
    import numpy as np
    import torch
    runner.learn(1)               # warm-up: the update's allocations
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in runner.net.parameters()]
    zero_launches()
    t0 = time.perf_counter()
    rows = runner.learn(ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    T = runner.cfg.runner.num_steps_per_env
    want = expected_launches(DEFAULT_ROUTE, ITERS * T, ITERS)
    if launches != want:
        raise AssertionError(f"learn({ITERS}): launches {launches}, "
                             f"expected {want}")
    check_rows("learn", rows)
    if all(torch.equal(a, b) for a, b in zip(before, runner.net.parameters())):
        raise AssertionError("learn: the params did not move")
    lr = float(runner.ppo.learning_rate)
    if not float(np.float32(1e-5)) <= lr <= float(np.float32(1e-2)):
        raise AssertionError(f"learn: learning rate {lr} out of its band")
    coll = [r["collection_time"] for r in rows]
    learn = [r["learning_time"] for r in rows]
    steps = ITERS * T * runner.env.num_envs
    say(5, f"learn({ITERS}) at {runner.env.num_envs} envs after one warm-up "
           f"iteration: {steps / wall:.1f} train-iteration env-steps/s "
           f"({wall:.3f} s); collection seconds per iteration {coll}, "
           f"learning seconds {learn}; update share "
           f"{sum(learn) / (sum(coll) + sum(learn)):.3f} ({card})")
    say(5, f"launches in the training path: {launches}; last stats: "
           + ", ".join(f"{k} {rows[-1][k]:.4g}" for k in (
               "value_loss", "surrogate_loss", "kl", "recons_loss",
               "vel_loss", "kld_loss", "height_loss", "lr")))
    return launches


def device_busy(fn):
    """fn() in one torch.profiler session (CUDA activity only) around a
    synchronized run: (its wall ms, its device ms, its device ops, the
    profiler's events with device time, largest first, and fn's
    result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return wall, busy, sum(e.count for e in events), events, out


def profile_phases(runner, card, top=6):
    """Device time of one collect and of one update, each in its own
    profiler session (`device_busy`): the busy share (device time over
    the phase's wall time), the number of device ops and the largest
    items."""
    batch = None
    for phase in ("collect", "update"):
        if phase == "collect":
            wall, busy, ops, events, (batch, _) = device_busy(runner.collect)
        else:
            wall, busy, ops, events, _ = device_busy(
                lambda: runner.ppo.update(batch, runner.generator))
        items = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                          f" x{e.count}" for e in events[:top])
        say(5, f"profiled {phase}: wall {wall:.1f} ms, device {busy:.2f} ms "
               f"(busy share {busy / wall:.3f}), {ops} device ops; largest: "
               f"{items} ({card})")


def other_task(name, registry, LeggedEnv, OnPolicyRunner, card):
    """Phase 8: `name` at its registry width.  Its env's kernels against
    their plain versions on a recorded step of the task (the budgets of
    phase 3); one collect and one learn(1), every launch counted from
    zero and held to the task's route (TASKS); a profiled collect for its
    device time.  Returns the kernel rows, labelled "kernel (task)", each
    with its launches in the collect."""
    import torch
    route = TASKS[name]
    task, train = registry.get_cfgs(name)
    t0 = time.perf_counter()
    env = LeggedEnv(task, device="cuda")
    runner = OnPolicyRunner(env, train)
    N, T = env.num_envs, train.runner.num_steps_per_env
    if env.terrain is None:
        world = "a plane"
    else:
        world = (f"terrain {tuple(env.grid.height.shape)} at "
                 f"{env.grid.horizontal_scale} m a cell from the "
                 f"{env.terrain.backend} generator")
        if env.terrain.backend != "native":
            raise AssertionError(f"{name}: terrain backend "
                                 f"{env.terrain.backend!r}, expected 'native'")
    say(8, f"{name}: {N} envs, {env.num_obs}-dim obs, robot "
           f"{task.asset.robot}, planner {task.use_dtc_planner}, {world}; "
           f"set up in {time.perf_counter() - t0:.1f} s")
    calls, runner.env_state = record_kernel_inputs(
        env, runner.env_params, runner.env_state, runner.generator, steps=2)
    ran = set(calls) - {"uniform_pm1"}
    if ran != set(route) | {"compute_rewards", "compute_observations"}:
        raise AssertionError(f"{name}: the step ran {sorted(ran)}")
    tables = (set() if env.patch_src is None
              else {id(env.patch_src.blocks), id(env.patch_src.blocks16)})
    results = compare_kernels(calls, tables, phase=8, main_path=False)
    del calls

    zero_launches()
    t0 = time.perf_counter()
    batch, aux = runner.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != expected_launches(route, T):
        raise AssertionError(f"{name} collect: launches {counts}, expected "
                             f"{expected_launches(route, T)}")
    for k, v in batch.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"{name} collect: batch[{k}] not finite")
    if batch["obs"].shape != (T, N, env.num_obs):
        raise AssertionError(f"{name}: obs {tuple(batch['obs'].shape)}")
    del batch
    pwall, busy, ops, _, _ = device_busy(runner.collect)
    zero_launches()
    rows = runner.learn(1)
    torch.cuda.synchronize()
    learn_counts = launch_counts()
    if learn_counts != expected_launches(route, T, 1):
        raise AssertionError(f"{name} learn(1): launches {learn_counts}")
    check_rows(f"{name} learn", rows)
    say(8, f"{name}: collect of {T} steps x {N} envs: {wall:.3f} s, "
           f"{T * N / wall:.1f} env-steps/s; launches {counts}; a profiled "
           f"collect: wall {pwall:.1f} ms, device {busy:.2f} ms (busy share "
           f"{busy / pwall:.3f}), {ops} device ops; learn(1): "
           f"{rows[0]['collection_time'] + rows[0]['learning_time']:.3f} s, "
           f"value loss {rows[0]['value_loss']:.4g}, the route's launches "
           f"and one gather ({card})")
    del runner, env
    torch.cuda.empty_cache()
    return {f"{k} ({name})": dict(r, launches=counts[k])
            for k, r in results.items()}


def staged_protocol(registry, LeggedEnv, OnPolicyRunner, card, iters=2):
    """Phase 8: the staged X30 protocol at 4096 envs
    (deep_tracking_control_tpu_torch/scripts/train_x30_staged.sh): an
    x30_rough runner learns `iters` iterations and saves its checkpoint;
    an x30_dtc runner loads it (params, both optimizers, the learning
    rate and the iteration transfer; the env state stays the runner's
    fresh one, as its episode-sum rows differ) and learns `iters`
    iterations, every launch counted."""
    import torch

    def runner(name, **kw):
        task, train = registry.get_cfgs(name)
        task = dataclasses.replace(
            task, env=dataclasses.replace(task.env, num_envs=NUM_ENVS))
        return OnPolicyRunner(LeggedEnv(task, device="cuda"), train, **kw)
    with tempfile.TemporaryDirectory(dir=HERE) as d:
        rough = runner("x30_rough", log_dir=d)
        T = rough.cfg.runner.num_steps_per_env
        zero_launches()
        check_rows("x30_rough learn", rough.learn(iters))
        counts = launch_counts()
        if counts != expected_launches(NO_PLANNER, iters * T, iters):
            raise AssertionError(f"x30_rough learn({iters}): launches "
                                 f"{counts}")
        dtc = runner("x30_dtc")
        fresh = dtc.env_state
        kept = {k: v.clone() for k, v in fresh.items()
                if isinstance(v, torch.Tensor)}
        dtc.load(os.path.join(d, f"model_{iters}.pt"))
    if dtc.env_state is not fresh or any(
            not torch.equal(v, fresh[k]) for k, v in kept.items()):
        raise AssertionError("staged: the x30_dtc env state was not kept")
    sums = (rough.env_state["episode_sums"].shape[0],
            fresh["episode_sums"].shape[0])
    pairs = [(f"params {k}", v, dtc.net.state_dict()[k])
             for k, v in rough.net.state_dict().items()]
    for opt in ("optimizer", "vae_optimizer"):
        a, b = getattr(rough.ppo, opt), getattr(dtc.ppo, opt)
        pairs += [(f"{opt} {m}", getattr(a, m), getattr(b, m))
                  for m in ("mu", "nu", "count")]
    pairs.append(("lr", rough.ppo.learning_rate, dtc.ppo.learning_rate))
    for what, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"staged: {what} not carried over")
    if dtc.current_learning_iteration != iters:
        raise AssertionError("staged: the iteration was not carried over")
    del rough
    before = [p.detach().clone() for p in dtc.net.parameters()]
    zero_launches()
    t0 = time.perf_counter()
    rows = dtc.learn(iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != expected_launches(DEFAULT_ROUTE, iters * T, iters):
        raise AssertionError(f"x30_dtc learn({iters}): launches {counts}")
    check_rows("x30_dtc learn", rows)
    if all(torch.equal(a, b) for a, b in zip(before, dtc.net.parameters())):
        raise AssertionError("staged: the params did not move")
    say(8, f"staged x30_rough -> x30_dtc at {NUM_ENVS} envs: x30_rough "
           f"learn({iters}) and its checkpoint; x30_dtc loaded it: {len(pairs)}"
           f" tensors carried, iteration {iters}, env state kept fresh "
           f"(episode-sum rows {sums[0]} -> {sums[1]}); x30_dtc learn({iters}):"
           f" {iters * T * NUM_ENVS / wall:.1f} train-iteration env-steps/s, "
           f"launches {counts}, value loss {rows[-1]['value_loss']:.4g} "
           f"({card})")
    del dtc
    torch.cuda.empty_cache()


def check_cosines(label, named_pairs):
    """The cosine of two gradients (the CPU's, the card's) per parameter
    group, from (name, cpu grad, card grad) triples; fails under 0.999.
    Returns the smallest."""
    import torch
    groups = {}
    for n, a, b in named_pairs:
        if a is not None:
            groups.setdefault(n.rsplit(".", 2)[0], []).append(
                (a.reshape(-1), b.reshape(-1).cpu()))
    worst = 1.0
    for grp, pairs in groups.items():
        a = torch.cat([x for x, _ in pairs]).double()
        b = torch.cat([y for _, y in pairs]).double()
        if float(a.norm()) > 0:
            cos = float(a @ b / (a.norm() * b.norm()))
            worst = min(worst, cos)
            if not cos >= 0.999:
                raise AssertionError(f"{label}: {grp} gradient cosine {cos}")
    return worst


def check_stats(label, cpu, card):
    """An update's stats on the card against the CPU's: 1e-6 + 1e-3 rel.
    Returns the largest relative error."""
    from deep_tracking_control_tpu_torch.agent.ppo import STAT_NAMES
    rel = 0.0
    for k in STAT_NAMES:
        got, want = float(card[k]), float(cpu[k])
        if not abs(got - want) <= 1e-6 + 1e-3 * abs(want):
            raise AssertionError(f"{label}: {k} {got} on the card, {want} on "
                                 f"the CPU")
        rel = max(rel, abs(got - want) / max(abs(want), 1e-12))
    return rel


def small_update_check():
    """One update of a small ActorCriticDecoder on the card against the
    same update on the CPU: same weights, batch and draws.  The learning
    rates are set small so that the params barely move between the 20
    minibatch steps and every step's stats are read at the same params on
    both sides (Adam's first steps move each entry by the sign of its
    gradient, so bf16 noise on a near-zero gradient would flip it): stats
    rtol 1e-3, and the first minibatch's gradients at cosine >= 0.999 per
    parameter group (the MLPs compute in bf16)."""
    import copy
    import numpy as np
    import torch
    from deep_tracking_control_tpu_torch.agent import ppo as tppo
    from deep_tracking_control_tpu_torch.env.config import AlgorithmCfg
    from deep_tracking_control_tpu_torch.models.networks import (
        ActorCriticDecoder)
    T, N = 8, 64
    rng = np.random.default_rng(0)
    f = np.float32
    mu = rng.normal(0, 0.3, (T, N, 12)).astype(f)
    sigma = rng.uniform(0.8, 1.2, (T, N, 12)).astype(f)
    arrays = dict(
        obs=rng.normal(size=(T, N, 53)), next_obs=rng.normal(size=(T, N, 53)),
        privileged_obs=rng.normal(size=(T, N, 1389)),
        obs_history=rng.normal(size=(T, N, 265)),
        base_vel=rng.normal(size=(T, N, 3)),
        actions=mu + sigma * rng.normal(size=(T, N, 12)), old_mu=mu,
        old_sigma=sigma, values=rng.normal(size=(T, N)),
        returns=rng.normal(size=(T, N)), advantages=rng.normal(size=(T, N)),
        old_log_prob=rng.normal(-15, 1, (T, N)))
    batch = {k: torch.from_numpy(v.astype(f)).to(
        torch.bfloat16 if k in ("privileged_obs", "obs_history")
        else torch.float32) for k, v in arrays.items()}
    net = ActorCriticDecoder(terrain_latent=32, actor_hidden=(32,),
                             critic_hidden=(32,),
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():           # trained-scale weights past layer 0
        for name, p in net.named_parameters():
            if name.endswith("weight") and ".layers.0." not in name:
                p.mul_(50.0)
    alg = AlgorithmCfg(learning_rate=1e-7, vae_learning_rate=1e-7)
    sides = {}
    for dev in ("cpu", "cuda"):
        ppo = tppo.PPO(net=copy.deepcopy(net).to(dev), alg=alg)
        sides[dev] = (ppo, {k: v.to(dev) for k, v in batch.items()})
    perm, eps = sides["cpu"][0].draw(T, N, torch.Generator().manual_seed(1),
                                     "cpu")
    grads = {}
    for dev, (ppo, b) in sides.items():
        mb = ppo.minibatch(ppo.shuffle(b, perm.to(dev)), 0, 1)
        _, _, vg, g = ppo.joint_grads(mb, eps[0, 0].to(dev), eps[0, 1].to(dev))
        grads[dev] = [(opt.names, gs) for opt, gs in
                      ((ppo.vae_optimizer, vg), (ppo.optimizer, g))]
    worst = min(check_cosines("small update", zip(names, gc, gg))
                for (names, gc), (_, gg) in zip(grads["cpu"], grads["cuda"]))
    stats = {dev: ppo.update(b, perm=perm.to(dev), eps=eps.to(dev))
             for dev, (ppo, b) in sides.items()}
    return worst, check_stats("small update", stats["cpu"], stats["cuda"])


def save_load_check(registry, LeggedEnv, OnPolicyRunner):
    """A 16-env runner on the card learns one iteration and saves; a fresh
    runner loads the file: params, both optimizers, the learning rate, the
    generator and the env state come back exactly."""
    import torch
    task, train = registry.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=16),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    a = OnPolicyRunner(LeggedEnv(task, device="cuda"), train)
    a.learn(1)
    b = OnPolicyRunner(LeggedEnv(task, device="cuda"), train)
    with tempfile.TemporaryDirectory(dir=HERE) as d:
        path = os.path.join(d, "model_1.pt")
        a.save(path)
        b.load(path)
    pairs = [(f"params {k}", v, b.net.state_dict()[k])
             for k, v in a.net.state_dict().items()]
    for name in ("optimizer", "vae_optimizer"):
        oa, ob = getattr(a.ppo, name), getattr(b.ppo, name)
        pairs += [(f"{name} {m}", getattr(oa, m), getattr(ob, m))
                  for m in ("mu", "nu", "count")]
    pairs.append(("learning rate", a.ppo.learning_rate, b.ppo.learning_rate))
    pairs.append(("generator", a.generator.get_state(),
                  b.generator.get_state()))

    def leaves(prefix, x, y):
        if isinstance(x, dict):
            for k in x:
                leaves(f"{prefix}.{k}", x[k], y[k])
        elif isinstance(x, torch.Tensor):
            pairs.append((prefix, x, y))
    leaves("env_state", a.env_state, b.env_state)
    for name, x, y in pairs:
        if x.device != y.device or not torch.equal(x, y):
            raise AssertionError(f"save/load: {name} differs")
    if b.current_learning_iteration != 1:
        raise AssertionError("save/load: the iteration was not restored")
    return len(pairs)


# the deployment path (phase 10): script -> (envs, steps, the kernels its
# route launches once a step beside EVERY_ROUTE).  debug_viz (play,
# teleop) takes the plain planner: no K3; on the plane (play_plane) no
# K1-K3, as the JAX env's route there
DEBUG_ROUTE = ("decimation_step", "sample_all")
DEPLOY = {"play_single": (1, 50, DEFAULT_ROUTE), "play_plane": (1, 50, ()),
          "teleop": (4, 6, DEBUG_ROUTE),
          "eval_stones": (64, 200, DEFAULT_ROUTE),
          "play": (100, 50, DEBUG_ROUTE),
          "analyze_terminations": (256, 200, DEFAULT_ROUTE)}
TELEOP_KEYS = "wwaqnr"


def clone_tree(x):
    import torch
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def tail_lines(fn, n):
    """fn()'s result, with only the last n lines of what it printed."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    lines = buf.getvalue().rstrip().splitlines()
    if n:
        print("\n".join(lines[-n:]), flush=True)
    return out


def deploy_script(name, log_root, saved, card):
    """Phase 10, one script: its set-up from the saved checkpoint (loaded
    without the optimizers; the checkpoint's 4096-env state is not
    adopted), its kernels against their plain versions on a recorded step
    of its env, then its rollout with every launch counted from zero and
    held to its route, and its report with the env-steps/s.  Returns the
    kernel rows, labelled "kernel (script, N)"."""
    import importlib
    import torch
    mod = importlib.import_module(
        f"deep_tracking_control_tpu_torch.scripts.{name}")
    common = importlib.import_module(
        "deep_tracking_control_tpu_torch.scripts.common")
    N, steps, route = DEPLOY[name]
    argv = ["--task", "lite3_dtc", "--log_root", log_root]
    t0 = t_all = time.perf_counter()
    if name == "teleop":
        sess = mod.build(mod.parse_args(argv + ["--num_envs", str(N)]))
        env, params, state = sess.env, sess.params, sess.state
    elif name == "eval_stones":
        env, runner, policy = mod.setup(common.parse_args(argv), num_envs=N,
                                        difficulty=0.45)
    elif name == "analyze_terminations":
        env, runner, policy = mod.setup(mod.parse_args(
            argv + ["--num_envs", str(N)]))
    else:
        env, runner, policy = mod.setup(common.parse_args(argv))
    if env.num_envs != N:
        raise AssertionError(f"{name}: {env.num_envs} envs, expected {N}")
    if name != "teleop":
        params, state = runner.env_params, runner.env_state
        for k, v in saved["params"].items():
            if not torch.equal(runner.net.state_dict()[k], v):
                raise AssertionError(f"{name}: params {k} not loaded")
        for opt in (runner.ppo.optimizer, runner.ppo.vae_optimizer):
            if int(opt.count) != 0 or bool(opt.mu.any()):
                raise AssertionError(f"{name}: the optimizers were loaded")
        if runner.current_learning_iteration != saved["iter"]:
            raise AssertionError(f"{name}: iteration not loaded")
    if state["commands"].shape[0] != N:
        raise AssertionError(f"{name}: the checkpoint's env state adopted")
    world = ("a plane" if env.terrain is None else
             f"terrain {tuple(env.grid.height.shape)} from the "
             f"{env.terrain.backend} generator")
    say(10, f"{name}: {N} envs, debug_viz {env.cfg.env.debug_viz}, {world};"
            f" set up and loaded in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator("cuda").manual_seed(5)
    calls, _ = record_kernel_inputs(env, params, clone_tree(state), gen,
                                    steps=2)
    ran = set(calls) - {"uniform_pm1"}
    if ran != set(route) | {"compute_rewards", "compute_observations"}:
        raise AssertionError(f"{name}: the step ran {sorted(ran)}")
    tables = (set() if env.patch_src is None
              else {id(env.patch_src.blocks), id(env.patch_src.blocks16)})
    results = compare_kernels(calls, tables, phase=10, main_path=False,
                              float64_physics=False)
    del calls

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name == "teleop":
        for k in TELEOP_KEYS:
            if not sess.handle_key(ord(k)):
                raise AssertionError(f"teleop: key {k} ended the session")
            tel = sess.step()
        if sess.handle_key(27) or not sess.quit:
            raise AssertionError("teleop: ESC did not end the session")
        wall = time.perf_counter() - t0
        rows = sess.ascii_map(21, 41)
        if len(rows) != 21 or not any("B" in r for r in rows):
            raise AssertionError("teleop: the ASCII map has no base")
        if not math.isfinite(sum(tel["vel"])) or sess.lookat != 1:
            raise AssertionError(f"teleop: telemetry {tel}")
        cmd = " ".join(f"{v:+.2f}" for v in tel["cmd"])
        report = (f"keys {' '.join(TELEOP_KEYS)} ESC: env {tel['lookat']} "
                  f"cmd ({cmd}) vel ({tel['vel'][0]:+.3f} "
                  f"{tel['vel'][1]:+.3f}) z {tel['z']:.3f}; ascii_map "
                  f"{len(rows)} x {len(rows[0])}")
        want = expected_launches(route, steps)
        want["uniform_pm1"] += 1          # the R key's reset
    else:
        gen = torch.Generator("cuda").manual_seed(7)
        if name == "play":
            out = tail_lines(lambda: mod.rollout(
                env, params, state, policy, gen, steps), 1)
        else:
            out = mod.rollout(env, params, state, policy, gen, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "eval_stones":
            rep = tail_lines(lambda: mod.report(*out[1:]), 0)
            report = (f"tracking err xy mean "
                      f"{rep['tracking_err_xy_mean_mps']:.4f} m/s, p90 "
                      f"{rep['tracking_err_xy_p90_mps']:.4f}, falls "
                      f"{rep['falls']}, episodes {rep['episodes']}")
        elif name == "analyze_terminations":
            rep = tail_lines(lambda: mod.report(
                "lite3_dtc", env.cfg.terrain, out[1], N, steps), 0)
            report = (f"ended {rep['n_done']:.0f}, causes " + ", ".join(
                f"{c} {rep[c]:.0f}" for c in mod.CAUSES)
                + f", by level {rep['done_by_level']}")
        elif name == "play":
            report = f"{steps} steps, env 0 printed every 10"
        else:
            log = out[1]
            tail_lines(lambda: mod.report(env.cfg, log), 2)
            report = (f"last step cmd_x {log[-1, 0]:+.2f} vel_x "
                      f"{log[-1, 1]:+.3f} z {log[-1, 2]:+.3f}")
        final = out[0]
        for k in ("obs", "privileged_obs"):
            if not bool(torch.isfinite(final[k]).all()):
                raise AssertionError(f"{name}: {k} not finite")
        want = expected_launches(route, steps)
    counts = launch_counts()
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    say(10, f"{name}: {report}; {steps} steps x {N} envs in {wall:.3f} s, "
            f"{steps * N / wall:.1f} env-steps/s; launches {counts}; the "
            f"script's phase {time.perf_counter() - t_all:.1f} s ({card})")
    del env
    torch.cuda.empty_cache()
    return {f"{k} ({name}, {N})": dict(r, launches=counts[k])
            for k, r in results.items()}


def export_check(log_root):
    """Phase 10: play_single's runner (the saved checkpoint, loaded
    without the optimizers) exports act_teacher at batch 1 on the card;
    the loaded program against get_inference_policy(teacher=True) on the
    same inputs: max abs err 0 (the same aten ops on the same inputs)."""
    import torch
    from deep_tracking_control_tpu_torch.runner import export
    from deep_tracking_control_tpu_torch.scripts import common, play_single
    env, runner, policy = play_single.setup(common.parse_args(
        ["--task", "lite3_dtc", "--log_root", log_root]))
    t0 = time.perf_counter()
    path = export.export_policy(runner.net, env.num_obs, env.num_obs_history,
                                env.num_privileged_obs,
                                os.path.join(log_root, "export"))
    fn = export.load_policy(os.path.dirname(path))
    secs = time.perf_counter() - t0
    s = runner.env_state
    g = torch.Generator("cuda").manual_seed(9)
    err = 0.0
    for i in range(4):
        x = [s["obs"], s["obs_history"], s["privileged_obs"]]
        if i:
            x = [v + torch.randn(v.shape, generator=g, device="cuda")
                 for v in x]
        got, want = fn(*x), policy(*x)
        if not got.is_cuda or got.shape != (1, env.num_actions):
            raise AssertionError(f"export: {got.device} {tuple(got.shape)}")
        err = max(err, float((got - want).abs().max()))
    if err != 0.0:
        raise AssertionError(f"export: max abs err {err} against the "
                             f"inference policy, expected 0")
    say(10, f"export: act_teacher at batch 1 on the card, "
            f"{os.path.getsize(path)} bytes, exported and loaded in "
            f"{secs:.1f} s; against get_inference_policy(teacher=True) on 4 "
            f"inputs: max abs err {err} (expected 0)")


def deployment_path(log_root, experiment, card):
    """Phase 10: every evaluation script at its width from the checkpoint
    under <log_root>/<experiment>, then the export."""
    import torch
    from deep_tracking_control_tpu_torch.runner import checkpoint as ckpt
    path = ckpt.get_load_path(os.path.join(log_root, experiment))
    saved = ckpt.load(path, "cuda")
    say(10, f"checkpoint {os.path.basename(path)} of phase 5's runner "
            f"(iteration {saved['iter']})")
    results = {}
    t0 = time.perf_counter()
    for name in DEPLOY:
        results.update(deploy_script(name, log_root, saved, card))
    export_check(log_root)
    torch.cuda.empty_cache()
    say(10, f"deployment path in {time.perf_counter() - t0:.1f} s")
    return results


# the other policies (phase 11): label -> (policy_class_name, rnn_type)
POLICIES = {"ActorCritic": ("ActorCritic", "gru"),
            "GRU": ("ActorCriticRecurrent", "gru"),
            "LSTM": ("ActorCriticRecurrent", "lstm")}


def with_policy(train, label):
    cls, rnn = POLICIES[label]
    return dataclasses.replace(train, policy=dataclasses.replace(
        train.policy, policy_class_name=cls, rnn_type=rnn))


def check_tf32_off(torch):
    """The float32 GEMMs of the card-vs-CPU checks must not run in TF32."""
    flags = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                 cudnn=torch.backends.cudnn.allow_tf32,
                 precision=torch.get_float32_matmul_precision())
    if flags["matmul"] or flags["cudnn"] or flags["precision"] != "highest":
        raise AssertionError(f"TF32 is on: {flags}")




def check_recurrent_runner(label, runner, batch):
    """The recurrent replay over a collect's batch from its rollout-start
    carries against the means and values collected step by step
    (atol 1e-5 + rtol 1e-5, as tests/test_recurrent_runner.py:78 holds
    JAX's); an act from the live carries; the inference policy advancing
    its carry.  Returns the replay's max abs err."""
    import torch
    ppo, N = runner.ppo, runner.env.num_envs
    with torch.no_grad():
        mean, _, value = ppo.replay(batch["obs"], batch["dones"],
                                    batch["init_carry_a"],
                                    batch["init_carry_c"])
    check_close(f"{label} replay mean", mean, batch["old_mu"], 1e-5, 1e-5)
    check_close(f"{label} replay value", value, batch["values"], 1e-5, 1e-5)
    err = max(float((mean - batch["old_mu"]).abs().max()),
              float((value - batch["values"]).abs().max()))
    obs = runner.env_state["obs"]
    carry = (runner.log_state["carry_a"], runner.log_state["carry_c"])
    a, ca, cc = ppo.act_recurrent(obs, *carry, runner.generator)
    if a["actions"].shape != (N, runner.env.num_actions) or not bool(
            torch.isfinite(a["actions"]).all()):
        raise AssertionError(f"{label} act: {tuple(a['actions'].shape)}")
    leaves = [c for x in (ca, cc) for c in (x if isinstance(x, tuple)
                                             else (x,))]
    if any(c.shape != (N, runner.cfg.policy.rnn_hidden_size)
           for c in leaves):
        raise AssertionError(f"{label} act: carries {[c.shape for c in leaves]}")
    policy = runner.get_inference_policy()
    fresh = (runner.init_carry(N), runner.init_carry(N))
    a1, carry = policy(obs, fresh)
    a2, carry = policy(obs, carry)
    if not float((a1 - a2).abs().max()) > 0:
        raise AssertionError(f"{label} inference policy: the carry did not "
                             f"advance")
    return err


def policy_runner(label, env, train, card, log_root):
    """Phase 11, one policy: learn(1), then learn(2) with every launch
    counted from zero; stats finite, params moved; the env-steps/s and
    the update share; one profiled collect, the policy's own checks on
    its batch (before the update moves the params), and one profiled
    update of it; a checkpoint under
    <log_root>/<label>/<experiment>/run.  Returns the launch counts."""
    import torch
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    t0 = time.perf_counter()
    runner = OnPolicyRunner(env, with_policy(train, label))
    kind = runner.ppo.policy_kind
    if kind != ("mlp" if label == "ActorCritic" else "recurrent"):
        raise AssertionError(f"{label}: policy kind {kind}")
    runner.learn(1)               # warm-up: the update's allocations
    setup = runner._clock() - t0
    before = [p.detach().clone() for p in runner.net.parameters()]
    zero_launches()
    t0 = runner._clock()
    rows = runner.learn(2)
    wall = runner._clock() - t0
    counts = launch_counts()
    T, N = runner.cfg.runner.num_steps_per_env, env.num_envs
    want = expected_launches(DEFAULT_ROUTE, 2 * T, 2 if kind == "mlp" else 0)
    if counts != want:
        raise AssertionError(f"{label} learn(2): launches {counts}, expected "
                             f"{want}")
    check_rows(f"{label} learn", rows)
    if all(torch.equal(a, b) for a, b in zip(before, runner.net.parameters())):
        raise AssertionError(f"{label} learn: the params did not move")
    coll = sum(r["collection_time"] for r in rows)
    learn = sum(r["learning_time"] for r in rows)
    say(11, f"{label}: learn(2) at {N} envs after one warm-up iteration "
            f"({setup:.1f} s with the set-up): {2 * T * N / wall:.1f} "
            f"train-iteration env-steps/s ({wall:.3f} s), collection "
            f"{2 * T * N / coll:.1f} env-steps/s, update share "
            f"{learn / (coll + learn):.3f}; launches {counts}; last stats: "
            + ", ".join(f"{k} {rows[-1][k]:.4g}" for k in (
                "value_loss", "surrogate_loss", "kl", "lr")) + f" ({card})")
    _, cbusy, cops, _, (batch, _) = device_busy(runner.collect)
    if kind == "mlp":
        flat, _, G = check_gather_bit_exact(runner.ppo, batch,
                                            runner.generator)
        say(11, f"{label}: permute_groups vs plain on its batch "
                f"({len(flat)} fields, {T * N} rows, G={G}): bit-exact")
    else:
        err = check_recurrent_runner(label, runner, batch)
        say(11, f"{label}: replay of a collect's {T} x {N} batch from its "
                f"rollout-start carries against the collected means and "
                f"values: max abs err {err:.3e} (budget 1e-5 + 1e-5 rel); "
                f"act and the inference policy advance the carry")
    update = runner.ppo.update if kind == "mlp" else runner.ppo.update_recurrent
    uwall, ubusy, uops, events, _ = device_busy(
        lambda: update(batch, runner.generator))
    items = "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.2f} ms"
                      f" x{e.count}" for e in events[:4])
    say(11, f"{label}: profiled collect {cbusy:.2f} ms device, {cops} ops; "
            f"update wall {uwall:.1f} ms, device {ubusy:.2f} ms (busy share "
            f"{ubusy / uwall:.3f}), {uops} device ops; largest: {items} "
            f"({card})")
    run = os.path.join(log_root, label, train.runner.experiment_name, "run")
    os.makedirs(run)
    runner.save(os.path.join(run, f"model_{runner.current_learning_iteration}"
                                  ".pt"))
    del runner, batch
    torch.cuda.empty_cache()
    return counts


def small_recurrent_update_check(rnn_type, device="cuda"):
    """One update_recurrent of a small ActorCriticRecurrent on the card
    (`device`) against the same update on the CPU: same weights, batch and
    env draws, TF32 off.  The learning rate is set small so every minibatch's
    stats are read at (nearly) the same params on both sides: the first
    minibatch's gradients at cosine >= 0.999 per parameter group and the
    stats at rtol 1e-3 (the heads compute in bf16; the cells in float32)."""
    import copy
    import numpy as np
    import torch
    from deep_tracking_control_tpu_torch.agent import ppo as tppo
    from deep_tracking_control_tpu_torch.env.config import AlgorithmCfg
    from deep_tracking_control_tpu_torch.models.networks import (
        ActorCriticRecurrent)
    check_tf32_off(torch)
    T, N, H = 8, 64, 32
    rng = np.random.default_rng(1)
    f = np.float32
    mu = rng.normal(0, 0.3, (T, N, 12)).astype(f)
    sigma = rng.uniform(0.8, 1.2, (T, N, 12)).astype(f)
    carry = [torch.from_numpy(rng.normal(0, 0.3, (N, H)).astype(f))
             for _ in range(4)]
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        obs=rng.normal(size=(T, N, 53)).astype(f),
        actions=(mu + sigma * rng.normal(size=(T, N, 12))).astype(f),
        old_mu=mu, old_sigma=sigma, values=rng.normal(size=(T, N)).astype(f),
        returns=rng.normal(size=(T, N)).astype(f),
        advantages=rng.normal(size=(T, N)).astype(f),
        old_log_prob=rng.normal(-15, 1, (T, N)).astype(f),
        dones=rng.random((T, N)) < 0.1).items()}
    batch["init_carry_a"] = (carry[0] if rnn_type == "gru"
                             else (carry[0], carry[1]))
    batch["init_carry_c"] = (carry[2] if rnn_type == "gru"
                             else (carry[2], carry[3]))
    net = ActorCriticRecurrent(rnn_hidden_size=H, rnn_type=rnn_type,
                               actor_hidden=(32,), critic_hidden=(32,),
                               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():           # trained-scale head weights past layer 0
        for name, p in net.named_parameters():
            if (name.endswith("weight") and ".layers.0." not in name
                    and not name.startswith("memory")):
                p.mul_(50.0)
    alg = AlgorithmCfg(learning_rate=1e-7)

    def on(x, dev):
        if isinstance(x, tuple):
            return tuple(on(v, dev) for v in x)
        return x.to(dev)
    sides = {dev: (tppo.PPO(net=copy.deepcopy(net).to(dev), alg=alg,
                            policy_kind="recurrent"),
                   {k: on(v, dev) for k, v in batch.items()})
             for dev in ("cpu", device)}
    idx = sides["cpu"][0].draw_recurrent(N, torch.Generator().manual_seed(1),
                                         "cpu")
    label = f"small {rnn_type} update"
    grads = {dev: ppo.recurrent_grads(b, idx[0].to(dev))[1]
             for dev, (ppo, b) in sides.items()}
    worst = check_cosines(label, zip(sides["cpu"][0].optimizer.names,
                                     grads["cpu"], grads[device]))
    stats = {dev: ppo.update_recurrent(b, env_idx=idx)
             for dev, (ppo, b) in sides.items()}
    return worst, check_stats(label, stats["cpu"], stats[device])


def policy_scripts(log_root, card, device="cuda"):
    """Phase 11: the GRU checkpoint through teleop's own set-up at 4 envs
    (the keys w w a q n r, each followed by a step; launches of the debug
    route), the MLP one through play_single's for 50 steps (launches of
    the default route)."""
    import torch
    from deep_tracking_control_tpu_torch.runner import checkpoint as ckpt
    from deep_tracking_control_tpu_torch.scripts import (common, play_single,
                                                         teleop)

    def transform(label):
        return lambda task, train: (task, with_policy(train, label))
    argv = ["--task", "lite3_dtc", "--device", device]
    root = os.path.join(log_root, "GRU")
    sess = teleop.build(teleop.parse_args(
        argv + ["--log_root", root, "--num_envs", "4"]),
        transform=transform("GRU"))
    zero_launches()
    t0 = time.perf_counter()
    for k in TELEOP_KEYS:
        if not sess.handle_key(ord(k)):
            raise AssertionError(f"teleop (GRU): key {k} ended the session")
        tel = sess.step()
    wall = time.perf_counter() - t0
    want = expected_launches(DEBUG_ROUTE, len(TELEOP_KEYS))
    want["uniform_pm1"] += 1          # the R key's reset
    counts = launch_counts()
    if counts != want or not math.isfinite(sum(tel["vel"])):
        raise AssertionError(f"teleop (GRU): launches {counts}, expected "
                             f"{want}; telemetry {tel}")
    say(11, f"teleop from the GRU checkpoint at {sess.env.num_envs} envs: "
            f"keys {' '.join(TELEOP_KEYS)}, {len(TELEOP_KEYS)} steps in "
            f"{wall:.3f} s, vel ({tel['vel'][0]:+.3f} {tel['vel'][1]:+.3f}); "
            f"launches {counts} ({card})")
    root = os.path.join(log_root, "ActorCritic")
    env, runner, policy = play_single.setup(
        common.parse_args(argv + ["--log_root", root]),
        transform=transform("ActorCritic"))
    saved = ckpt.load(ckpt.get_load_path(os.path.join(
        root, runner.cfg.runner.experiment_name)), device)["params"]
    if (runner.ppo.policy_kind != "mlp" or int(runner.ppo.optimizer.count)
            or any(not torch.equal(v, saved[k])
                   for k, v in runner.net.state_dict().items())):
        raise AssertionError(f"play_single: {runner.ppo.policy_kind} policy, "
                             f"optimizer count {int(runner.ppo.optimizer.count)}"
                             f", params loaded: not all")
    steps = DEPLOY["play_single"][1]
    zero_launches()
    t0 = runner._clock()
    state, log = play_single.rollout(
        env, runner.env_params, runner.env_state, policy,
        torch.Generator(device).manual_seed(7), steps)
    wall = runner._clock() - t0
    counts = launch_counts()
    if counts != expected_launches(DEFAULT_ROUTE, steps):
        raise AssertionError(f"play_single (ActorCritic): launches {counts}")
    if not bool(torch.isfinite(state["obs"]).all()):
        raise AssertionError("play_single (ActorCritic): obs not finite")
    say(11, f"play_single from the ActorCritic checkpoint: {steps} steps in "
            f"{wall:.3f} s ({steps / wall:.1f} env-steps/s), last step cmd_x "
            f"{log[-1, 0]:+.2f} vel_x {log[-1, 1]:+.3f} z {log[-1, 2]:+.3f}; "
            f"launches {counts} ({card})")


def other_policies(env, train, card):
    """Phase 11: the three policies on phase 3's env, the small recurrent
    updates card vs CPU, and the scripts from the checkpoints."""
    import torch
    t0 = time.perf_counter()
    log_root = tempfile.mkdtemp(dir=HERE)
    atexit.register(shutil.rmtree, log_root, True)
    for label in POLICIES:
        policy_runner(label, env, train, card, log_root)
    for rnn in ("gru", "lstm"):
        cos, rel = small_recurrent_update_check(rnn, env.device)
        say(11, f"small {rnn} update_recurrent on the card vs on the CPU "
                f"(TF32 off): gradient cosine >= {cos:.6f} (budget 0.999), "
                f"stats max rel err {rel:.3e} (budget 1e-3)")
    policy_scripts(log_root, card, env.device.type)
    torch.cuda.empty_cache()
    say(11, f"other policies in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the env axis sharded over torch.distributed ranks
# ---------------------------------------------------------------------------
SHARD_STATS = ("value_loss", "surrogate_loss", "recons_loss", "height_loss")
# the minibatch steps of iteration 1 whose stats (c) holds to the JAX
# package's budget: tests/test_multichip_equiv.py reads its iteration-1
# stats over two steps (one epoch of two minibatches); over the registry's
# 20 steps Adam's sign-sized first moves amplify the bf16 reduction-order
# noise of the gradient sums (the means over all 20 are printed)
SHARD_GATE_STEPS = 2
# limits on iteration 1's stats over all its steps, W=2 against W=1
# (relative), and on the first VAE and main gradients summed over the
# ranks against W=1's (relative L2 error, least cosine over the parameter
# tensors): twice the farthest reading of (c)'s three noise witnesses on
# the H100, rounded up (PERF.md; lr, a step function of kl, is
# read but not held)
SHARD_WHOLE_LIMIT = dict(value_loss=7e-3, surrogate_loss=0.3, entropy=4e-5,
                         kl=9e-2, recons_loss=8e-5, vel_loss=1e-3,
                         kld_loss=0.8, height_loss=2e-2)
SHARD_GRAD_REL = 6e-4
SHARD_GRAD_COS = 0.999
# the first minibatch's CE-net (mu, filtered logvar), the ranks' rows
# against W=1's: an outlier the ranks judge otherwise, or another center,
# moves an entry by ~1 (the ranks' GEMMs round a few entries by < 1e-6)
SHARD_CENET_ATOL = 1e-5
SHARD_ITERS = 2
SHARD_TIMEOUT = 600      # seconds a rank of (c) may take


def shard_learn(shard, strata, record=False, witness=None):
    """A fresh lite3_dtc runner (NUM_ENVS envs in all, `shard`'s block of
    them; shuffle_strata `strata`, None as registered) and learn(2) from
    zero launch counts.  Returns (runner, dict(rows, params, generator,
    launches, seconds, draws, step_stats, grads, cenet)); with `record`,
    draws holds the first collect's K8 outputs and the (seed, row0) of each
    K7 call, grads the gradients (this rank's, before the sum over the
    ranks) that the VAE and main optimizers step on first, by parameter
    name, and cenet the CE-net's (mu, filtered logvar) of the first
    minibatch; step_stats holds the stats of every minibatch step of the first
    update.  `witness` changes only the order of the sums over a
    minibatch's rows in the fused step: "reversed" reverses its rows (its
    latent draws with them), "halves" sums its gradients (and terms) from
    its two halves' shares of each mean, each share from a backward pass
    of its own, as two ranks do, and "split" runs every dense layer on
    each half of the rows apart, with a GEMM of two ranks' shape."""
    import torch
    from deep_tracking_control_tpu_torch.agent import ppo as tppo
    from deep_tracking_control_tpu_torch.env import cuda_obs
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.models import networks as tnet
    from deep_tracking_control_tpu_torch.ops import cuda_rng
    from deep_tracking_control_tpu_torch.parallel import mesh as pmesh
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from deep_tracking_control_tpu_torch.tasks import registry
    task, train = registry.get_cfgs("lite3_dtc")
    if strata is not None:
        train = dataclasses.replace(train, algorithm=dataclasses.replace(
            train.algorithm, shuffle_strata=strata))
    env = LeggedEnv(task, device="cuda", shard=shard)
    runner = OnPolicyRunner(env, train)
    T = train.runner.num_steps_per_env
    alg = train.algorithm
    draws = dict(k8=[], k7=[], H=env.num_height_points, num_obs=env.num_obs)
    originals = (cuda_rng.uniform_pm1, cuda_obs.compute_observations_fused)

    def k8(*args, **kwargs):
        out = originals[0](*args, **kwargs)
        if len(draws["k8"]) < T:
            draws["k8"].append(out.clone())
        return out

    def k7(*args, **kwargs):
        if len(draws["k7"]) < T:
            draws["k7"].append((args[-1].clone(), kwargs.get("row0", 0)))
        return originals[1](*args, **kwargs)
    torch.cuda.synchronize()
    zero_launches()
    # the recorders stand in for the wrappers (whose counts they leave to
    # them) during the run only
    if record:
        cuda_rng.uniform_pm1, cuda_obs.compute_observations_fused = k8, k7
    step_main = tppo.PPO._step_main
    steps = alg.num_learning_epochs * alg.num_mini_batches
    step_stats = []

    def recorded_step(self, *args):
        lr = step_main(self, *args)
        if len(step_stats) < steps:
            step_stats.append(args[-1][-1].cpu())
        return lr
    tppo.PPO._step_main = recorded_step
    adam_step, joint_grads = tppo.ClippedAdam.step, tppo.PPO.joint_grads
    cenet_stats = tnet.Vae.cenet_stats
    grads, latest, cenet = [], [], []

    def recorded_cenet(self, obs_history):
        latest[:] = [cenet_stats(self, obs_history)]
        return latest[0]

    def recorded_adam(self, gs, lr):
        if len(grads) < 2:
            grads.append({n: (torch.zeros_like(p) if g is None else g)
                          .detach().float().cpu()
                          for n, g, p in zip(self.names, gs, self.params)})
            if not cenet:           # the first minibatch's (mu, logvar)
                cenet.append([t.detach().float().cpu() for t in latest[0]])
        return adam_step(self, gs, lr)

    def reversed_grads(self, mb, eps_vae, eps_pol):
        idx = torch.arange(eps_vae.shape[0] - 1, -1, -1,
                           device=eps_vae.device)
        return joint_grads(self, {k: v[idx] for k, v in mb.items()},
                           eps_vae[idx], eps_pol[idx])

    def halved_grads(self, mb, eps_vae, eps_pol):
        halves = []
        for h in (0, 1):
            def share(x, shard=None, count=None, h=h):
                m = x.shape[0] // 2
                return (x[:m] if h == 0 else x[m:]).sum() / x.numel()
            pmesh.mean = share
            try:
                halves.append(joint_grads(self, mb, eps_vae, eps_pol))
            finally:
                pmesh.mean = plain_mean
        (p0, q0, v0, g0), (p1, q1, v1, g1) = halves

        def add(a, b):
            return b if a is None else a if b is None else a + b
        return (tuple(map(add, p0, p1)), tuple(map(add, q0, q1)),
                list(map(add, v0, v1)), list(map(add, g0, g1)))
    def split_dense(layer, x):
        m = x.shape[0] // 2
        return torch.cat([dense_forward(layer, x[:m]),
                          dense_forward(layer, x[m:])])

    def split_grads(self, mb, eps_vae, eps_pol):
        tnet.Dense.forward = split_dense
        try:
            return joint_grads(self, mb, eps_vae, eps_pol)
        finally:
            tnet.Dense.forward = dense_forward
    plain_mean, dense_forward = pmesh.mean, tnet.Dense.forward
    if record:
        tppo.ClippedAdam.step = recorded_adam
        tnet.Vae.cenet_stats = recorded_cenet
    if witness is not None:
        tppo.PPO.joint_grads = dict(reversed=reversed_grads,
                                    halves=halved_grads,
                                    split=split_grads)[witness]
    try:
        t0 = time.perf_counter()
        rows = runner.learn(SHARD_ITERS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cuda_rng.uniform_pm1, cuda_obs.compute_observations_fused = originals
        tppo.PPO._step_main = step_main
        tppo.ClippedAdam.step, tppo.PPO.joint_grads = adam_step, joint_grads
        tnet.Vae.cenet_stats = cenet_stats
    launches = launch_counts()
    want = expected_launches(DEFAULT_ROUTE, SHARD_ITERS * T, SHARD_ITERS)
    if launches != want:
        raise AssertionError(f"learn({SHARD_ITERS}) of {env.num_envs} envs: "
                             f"launches {launches}, expected {want}")
    check_rows("sharded learn", rows)
    n_all = env.num_envs if shard is None else shard.num_envs
    last = rows[-1]["collection_time"] + rows[-1]["learning_time"]
    return runner, dict(
        rows=rows, launches=launches, seconds=seconds, draws=draws,
        step_stats=torch.stack(step_stats), rate=T * n_all / last,
        grads=grads, cenet=cenet[0] if cenet else None,
        params={k: v.detach().clone()
                for k, v in runner.net.state_dict().items()},
        generator=runner.generator.get_state(), n_local=env.num_envs)


def shard_rank_main(rank, world, store, out):
    """A rank of phase 13 (c), in its own process: the group over gloo (NCCL
    refuses two ranks on one device), its block of lite3_dtc and learn(2)
    at shuffle_strata 2; its results go to out/rank{rank}.pt."""
    import torch
    sys.path.insert(0, HERE)
    from deep_tracking_control_tpu_torch.parallel import distributed as pdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.initialize(backend="gloo", init_method="file://" + store,
                     world_size=world, rank=rank)
    shard = pdist.global_shard(NUM_ENVS)
    runner, res = shard_learn(shard, world, record=True)
    del runner
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    pdist.barrier()
    pdist.shutdown()


def run_ranks(world, root, timeout=SHARD_TIMEOUT):
    """Start `world` rank processes of this script on the card and wait for
    all; a rank that fails or outlives `timeout` ends them all and fails
    the phase with its output.  Returns each rank's results."""
    import torch
    store = os.path.join(root, "store")
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(root, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
             "--world", str(world), "--store", store, "--out", root],
            stdout=logs[-1], stderr=subprocess.STDOUT, cwd=HERE))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad[0] if bad else "timeout"
                break
            time.sleep(0.5)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                        + "".join(f.readlines()[-40:]))
        raise AssertionError(f"phase 13: rank {failed} failed\n"
                             + "\n".join(text))
    for f in logs:
        f.close()
    return [torch.load(os.path.join(root, f"rank{r}.pt"), map_location="cpu",
                       weights_only=False) for r in range(world)]


def offset_kernels(runner, card):
    """Phase 13 (a): K8 at element offsets and K7 at row0 = NUM_ENVS / 2,
    each bit for bit against the rows of the full-size kernel output and
    against its plain version; the offset rows' times and bounds."""
    import torch
    from deep_tracking_control_tpu_torch.env import cuda_obs
    from deep_tracking_control_tpu_torch.ops import cuda_rng
    g = torch.Generator("cuda").manual_seed(13)
    seed = cuda_rng.draw_seed(g, "cuda")
    half = NUM_ENVS // 2
    checked = 0
    for D in (20, 17, 693, 53):
        full = cuda_rng.uniform_pm1(seed, (NUM_ENVS, D), 1)
        for r in (1, 2, 3, 5, half, NUM_ENVS - 7):
            n = min(NUM_ENVS - r, half)
            got = cuda_rng.uniform_pm1(seed, (n, D), 1, r * D)
            if not torch.equal(got, full[r:r + n]):
                raise AssertionError(f"uniform_pm1 ({n}, {D}) at row {r}: not "
                                     f"the rows of the ({NUM_ENVS}, {D}) draw")
            if not torch.equal(got, cuda_rng.uniform_pm1_plain(seed, (n, D), 1,
                                                               r * D)):
                raise AssertionError(f"uniform_pm1 ({n}, {D}) at row {r}: "
                                     f"differs from plain")
            checked += 1
    env = runner.env
    calls, runner.env_state = record_kernel_inputs(
        env, runner.env_params, runner.env_state, runner.generator, steps=1)
    args, _ = calls["compute_observations"]
    # the step's inputs cut in half: env-leading rows, q and qd columns
    cut = [a[half:] if i in (2, 3, 4, 7, 8, 9, 10, 11, 12, 13)
           else a[:, half:] if i in (5, 6) else a for i, a in enumerate(args)]
    whole = cuda_obs.compute_observations_fused(*args)
    got = cuda_obs.compute_observations_fused(*cut, row0=half)
    plain = cuda_obs.observations_plain(*cut, row0=half)
    for name, w, a, b in zip(("obs", "privileged", "history"), whole, got,
                             plain):
        if not torch.equal(a, w[half:]):
            raise AssertionError(f"compute_observations {name} at row0 "
                                 f"{half}: not the rows of the full output")
        if not torch.equal(a, b):
            raise AssertionError(f"compute_observations {name} at row0 "
                                 f"{half}: differs from plain")
    say(13, f"(a) uniform_pm1 bit for bit at {checked} row offsets (D = 20, "
            f"17, 693, 53; rows 1, 2, 3, 5, {half}, {NUM_ENVS - 7}) against "
            f"the rows of the ({NUM_ENVS}, D) draw and the plain version; "
            f"compute_observations at row0 {half} on the {NUM_ENVS}-env "
            f"step's inputs cut in half bit for bit against rows "
            f"{half}-{NUM_ENVS - 1} of the full output and the plain version")
    results = {}
    H, num_obs = args[10].shape[1], args[14].shape[0]
    drawn = half * H + (half * num_obs if args[0].noise.add_noise else 0)
    r = results["compute_observations (row offset)"] = dict(
        max_abs_err=0.0, **timings(
            torch, "compute_observations",
            lambda: cuda_obs.compute_observations_fused(*cut, row0=half),
            lambda: cuda_obs.observations_plain(*cut, row0=half)))
    check_launch("compute_observations (row offset)", r["launch"],
                 *cuda_obs.launch_shape(half)[:2])
    r.update(bound(tensor_bytes(cut), tensor_bytes(got), count_ops(
        lambda: cuda_obs.observations_plain(*cut, row0=half))
        + PHILOX_OPS * drawn))
    shape = (half, env.num_actions + 8)
    off = half * shape[1]

    def library():
        return torch.empty(shape, device="cuda").uniform_(-1.0, 1.0,
                                                          generator=g)
    r = results["uniform_pm1 (row offset)"] = dict(
        max_abs_err=0.0, library_ms=device_ms(torch, library), **timings(
            torch, "uniform_pm1",
            lambda: cuda_rng.uniform_pm1(seed, shape, 0, off),
            lambda: cuda_rng.uniform_pm1_plain(seed, shape, 0, off)))
    check_launch("uniform_pm1 (row offset)", r["launch"],
                 *cuda_rng.launch_shape(shape[0] * shape[1], off))
    r.update(bound(16, shape[0] * shape[1] * 4,
                   PHILOX_OPS * shape[0] * shape[1]))
    for k, r in results.items():
        say(13, f"(a) {k}: device time per call, mean of {REPEATS}: kernel "
                f"call {r['ms']:.4f} ms (its CUDA kernel alone "
                f"{r['kernel_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms"
                + (f", uniform_ {r['library_ms']:.4f} ms"
                   if r.get("library_ms") is not None else "")
                + f"; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                  f"({card})")
    return results


def max_abs(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def grad_gap(got, want):
    """(relative L2 error, least cosine over the parameter tensors, that
    tensor's name) of gradients `got` against `want` (name -> tensor)."""
    num = den = 0.0
    least, where = 1.0, None
    for n, w in want.items():
        g, w = got[n].double(), w.double()
        num += float((g - w).square().sum())
        den += float(w.square().sum())
        gn, wn = float(g.norm()), float(w.norm())
        cos = (float((g * w).sum()) / (gn * wn) if gn and wn
               else float(gn == wn))
        if cos < least:
            least, where = cos, n
    return math.sqrt(num / den), least, where


def reading(step_stats, grads, ref):
    """How far a run of phase 13 (c) is from W=1 (`ref`): the relative
    diff of each of iteration 1's stats in its first minibatch step
    ("one"), over its first SHARD_GATE_STEPS ("two", with the values in
    "two_abs") and over all of them ("whole"), and grad_gap of its first
    VAE and main gradients."""
    from deep_tracking_control_tpu_torch.agent.ppo import STAT_NAMES
    out = dict(one={}, two={}, two_abs={}, whole={})
    for i, k in enumerate(STAT_NAMES):
        for key, n in (("one", 1), ("two", SHARD_GATE_STEPS),
                       ("whole", None)):
            a = float(step_stats[:n, i].mean())
            b = float(ref["step_stats"][:n, i].mean())
            out[key][k] = abs(a - b) / max(abs(b), 1e-12)
            if key == "two":
                out["two_abs"][k] = (a, b)
    out["grads"] = [grad_gap(g, w) for g, w in zip(grads, ref["grads"])]
    return out


def sharded_training(card):
    """Phase 13: (a) the noise kernels at a row offset, (b) W=1 through
    `initialize` (nccl) against the plain runner, exact, (c) W=2 on the one
    card (gloo) against W=1 at shuffle_strata 2.  Returns the kernel rows
    of (a)."""
    import torch
    from deep_tracking_control_tpu_torch.ops import cuda_rng
    from deep_tracking_control_tpu_torch.parallel import distributed as pdist
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(dir=HERE)
    atexit.register(shutil.rmtree, root, True)
    # (b) the plain runner, then W=1 through initialize, from one seed
    plain_runner, plain = shard_learn(None, None)
    store = "file://" + os.path.join(root, "store1")
    dev = pdist.initialize(backend="nccl", init_method=store, world_size=1,
                           rank=0)
    if dev != torch.device("cuda", 0):
        raise AssertionError(f"initialize: device {dev}")
    try:
        shard = pdist.global_shard(NUM_ENVS)
        runner1, one = shard_learn(shard, None)
        del runner1
    finally:
        pdist.shutdown()
    keys = [k for k in plain["rows"][0]
            if not k.endswith("_time") and k != "trace"]
    err_stats = max(abs(a[k] - b[k])
                    for a, b in zip(plain["rows"], one["rows"]) for k in keys)
    err_params = max_abs(plain["params"].values(), one["params"].values())
    if err_stats or err_params:
        raise AssertionError(f"(b) W=1 through initialize vs the plain "
                             f"runner: stats max abs err {err_stats}, params "
                             f"{err_params}; expected 0")
    say(13, f"(b) W=1 through initialize (nccl, one rank, shard "
            f"{shard.row0}-{shard.row0 + shard.n_local - 1}) vs the plain "
            f"runner, learn({SHARD_ITERS}) from one seed at {NUM_ENVS} envs: "
            f"stats ({len(keys)} a row) and params max abs err 0; launches "
            f"{one['launches']}; train-iteration env-steps/s of iteration 2 "
            f"{one['rate']:.1f} sharded, {plain['rate']:.1f} plain "
            f"(learn({SHARD_ITERS}) {one['seconds']:.2f} s and "
            f"{plain['seconds']:.2f} s) ({card})")
    results = offset_kernels(plain_runner, card)
    del plain_runner
    torch.cuda.empty_cache()

    # (c) W=2 on the one card against W=1 at shuffle_strata 2
    ref_runner, ref = shard_learn(None, 2, record=True)
    del ref_runner
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(2, root)
    rank_s = time.perf_counter() - t0
    half = NUM_ENVS // 2
    for k in ranks[0]["params"]:
        if not torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]):
            raise AssertionError(f"(c) params {k} differ between the ranks")
    if not torch.equal(ranks[0]["generator"], ranks[1]["generator"]):
        raise AssertionError("(c) the ranks' generator states differ")
    if not torch.equal(ranks[0]["generator"], ref["generator"].cpu()):
        raise AssertionError("(c) the ranks' generator state is not W=1's")
    got, want = ranks[1]["draws"], ref["draws"]
    if len(got["k8"]) != len(want["k8"]) or len(got["k7"]) != len(want["k7"]):
        raise AssertionError(f"(c) draws recorded: rank 1 {len(got['k8'])} "
                             f"K8, {len(got['k7'])} K7; W=1 {len(want['k8'])},"
                             f" {len(want['k7'])}")
    for a, b in zip(got["k8"], want["k8"]):
        if not torch.equal(a, b[half:].cpu()):
            raise AssertionError("(c) rank 1's reset uniforms are not rows "
                                 f"{half}-{NUM_ENVS - 1} of W=1's")
    H, num_obs = want["H"], want["num_obs"]
    for (s1, row0), (s0, _) in zip(got["k7"], want["k7"]):
        if row0 != half or not torch.equal(s1, s0.cpu()):
            raise AssertionError(f"(c) rank 1's obs noise seed or row0 "
                                 f"({row0}) is not W=1's")
        s0 = s0.cuda()
        for stream, D in ((0, H), (1, num_obs)):
            if not torch.equal(
                    cuda_rng.uniform_pm1(s0, (half, D), stream, half * D),
                    cuda_rng.uniform_pm1(s0, (NUM_ENVS, D), stream)[half:]):
                raise AssertionError("(c) rank 1's obs noise is not rows "
                                     f"{half}-{NUM_ENVS - 1} of W=1's")
    # the noise witnesses: W=1 with only the order and rounding of the
    # sums over a minibatch's rows changed (no shard, the same rows and
    # draws)
    witnesses = {}
    for label in ("reversed", "halves", "split"):
        w_runner, witnesses[label] = shard_learn(None, 2, record=True,
                                                 witness=label)
        del w_runner
        torch.cuda.empty_cache()
    summed = [{n: ranks[0]["grads"][j][n] + ranks[1]["grads"][j][n]
               for n in ranks[0]["grads"][j]} for j in range(2)]
    readings = {"W=2": reading(ranks[0]["step_stats"], summed, ref)}
    for label, w in witnesses.items():
        readings[label] = reading(w["step_stats"], w["grads"], ref)
    got_w2 = readings["W=2"]
    for k in SHARD_STATS:
        a, b = got_w2["two_abs"][k]
        if not abs(a - b) <= 1e-5 + 2e-3 * abs(b):
            raise AssertionError(
                f"(c) iteration 1, first {SHARD_GATE_STEPS} minibatch steps, "
                f"{k}: {a} at W=2, {b} at W=1 (budget 2e-3 rel + 1e-5)")
    for k, limit in SHARD_WHOLE_LIMIT.items():
        if not got_w2["whole"][k] <= limit:
            raise AssertionError(
                f"(c) iteration 1, all its minibatch steps, {k}: rel diff "
                f"{got_w2['whole'][k]:.3e} W=2 against W=1 (limit {limit}; "
                f"the witnesses': " + ", ".join(
                    f"{lb} {r['whole'][k]:.3e}" for lb, r in readings.items()
                    if lb != "W=2") + ")")
    for j, opt in enumerate(("VAE", "main")):
        rel_l2, cos, name = got_w2["grads"][j]
        if not (rel_l2 <= SHARD_GRAD_REL and cos >= SHARD_GRAD_COS):
            raise AssertionError(
                f"(c) the {opt} optimizer's first gradients, summed over the "
                f"ranks, against W=1's: rel L2 err {rel_l2:.3e} (limit "
                f"{SHARD_GRAD_REL}), least cosine {cos:.6f} at {name} "
                f"(limit {SHARD_GRAD_COS})")
    say(13, f"(c) W=2 on one card (gloo, two processes of {half} envs) vs "
            f"W=1, shuffle_strata 2, learn({SHARD_ITERS}): rank 1's K8 and K7 "
            f"draws of the first collect ({len(got['k8'])} steps) are rows "
            f"{half}-{NUM_ENVS - 1} of W=1's bit for bit; params and "
            f"generator states equal on both ranks bit for bit; iteration 1's "
            f"{', '.join(SHARD_STATS)} over its first {SHARD_GATE_STEPS} "
            f"minibatch steps within 2e-3 rel + 1e-5; its stats over all "
            f"steps within {SHARD_WHOLE_LIMIT}; the first VAE and main "
            f"gradients summed over the ranks within rel L2 "
            f"{SHARD_GRAD_REL} and cosine >= {SHARD_GRAD_COS} per tensor; "
            f"each rank's launches {ranks[0]['launches']} (the default "
            f"route's)")
    want_mu, want_lv = ref["cenet"]
    for label, (mu, lv) in (
            ("W=2", [torch.cat(t) for t in zip(*(r["cenet"] for r in ranks))]),
            *((k, w["cenet"]) for k, w in witnesses.items()
              if k != "reversed")):
        err = max(float((mu - want_mu).abs().max()),
                  float((lv - want_lv).abs().max()))
        if label == "W=2" and not err <= SHARD_CENET_ATOL:
            raise AssertionError(
                f"(c) the first minibatch's CE-net (mu, filtered logvar) on "
                f"the ranks against W=1's rows: max abs err {err:.3e} "
                f"(limit {SHARD_CENET_ATOL}; the outlier filter's mean, std "
                f"and median are global)")
        say(13, f"(c) the first minibatch's CE-net, {label} against W=1: mu "
                f"{int((mu != want_mu).sum())} of {mu.numel()} entries "
                f"differ, filtered logvar {int((lv != want_lv).sum())} of "
                f"{lv.numel()}; max abs err {err:.3e}"
                + (f" (limit {SHARD_CENET_ATOL})" if label == "W=2" else ""))
    for label, r in readings.items():
        say(13, f"(c) reading {label} against W=1: first VAE / main "
                f"gradients rel L2 err {r['grads'][0][0]:.3e} / "
                f"{r['grads'][1][0]:.3e}, least cosine {r['grads'][0][1]:.7f}"
                f" ({r['grads'][0][2]}) / {r['grads'][1][1]:.7f} "
                f"({r['grads'][1][2]}); iteration 1's stats rel diff in its "
                f"first step " + ", ".join(
                    f"{k} {r['one'][k]:.3e}" for k in r["one"])
                + f"; over its first {SHARD_GATE_STEPS} steps " + ", ".join(
                    f"{k} {r['two'][k]:.3e}" for k in r["two"])
                + "; over all its steps " + ", ".join(
                    f"{k} {r['whole'][k]:.3e}" for k in r["whole"]))
    say(13, f"(c) train-iteration env-steps/s of iteration 2: W=2 "
            f"{ranks[0]['rate']:.1f} (rank 0's learn({SHARD_ITERS}) "
            f"{ranks[0]['seconds']:.2f} s; the two processes share one card "
            f"and all-reduce through the host, so this is no scaling number), "
            f"W=1 {ref['rate']:.1f} (learn({SHARD_ITERS}) {ref['seconds']:.2f}"
            f" s); the ranks' processes took {rank_s:.1f} s with start-up "
            f"({card})")
    for name, r in results.items():
        r["launches"] = ranks[1]["launches"][name.split(" (")[0]]
    say(13, f"phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return results


# ---------------------------------------------------------------------------
# phase 14: the A/B training-outcome scripts
# ---------------------------------------------------------------------------
AB_ITERS = 2


def ab_scripts(card):
    """Phase 14: each A/B script's `run_variant` (scripts/ab_granule.py:
    G=1 and G=16; scripts/ab_fused_step.py: sequential and fused) at
    NUM_ENVS envs for AB_ITERS iterations a variant, every launch of a
    call counted from zero: the env's init resets every env once (one
    noise-kernel launch), then each iteration launches the default
    route's kernels once a step and the gather once; iteration 0 (the
    first collect, before any update) the same in both variants of a
    script.  Returns the launch counts summed over the four calls."""
    from deep_tracking_control_tpu_torch.scripts import (ab_fused_step,
                                                         ab_granule)
    t_phase = time.perf_counter()
    T = ab_granule.variant_cfgs(1, NUM_ENVS)[1].runner.num_steps_per_env
    want = expected_launches(DEFAULT_ROUTE, AB_ITERS * T, AB_ITERS)
    want["uniform_pm1"] += 1
    total = dict.fromkeys(KERNELS, 0)
    for script in (ab_granule, ab_fused_step):
        name = script.__name__.rsplit(".", 1)[1]
        curves = []
        for value in script.VARIANTS:
            zero_launches()
            rew, ln, wall = script.run_variant(value, AB_ITERS, NUM_ENVS)
            got = launch_counts()
            if got != want:
                raise AssertionError(f"{name} {value}: launches {got}, "
                                     f"expected {want}")
            if 0 not in rew or 0 not in ln or not all(
                    math.isfinite(v) for v in (*rew.values(), *ln.values())):
                raise AssertionError(f"{name} {value}: curve {rew}, {ln}")
            for k, n in got.items():
                total[k] += n
            curves.append((rew, ln))
            say(14, f"{name} {value}: learn({AB_ITERS}) at {NUM_ENVS} envs "
                    f"{wall:.2f} s; curve rew {rew}, len {ln}; launches "
                    f"{got} ({card})")
        (rew_a, len_a), (rew_b, len_b) = curves
        if (rew_a[0], len_a[0]) != (rew_b[0], len_b[0]):
            raise AssertionError(f"{name}: iteration 0 differs between its "
                                 f"variants: {rew_a[0]}, {len_a[0]} against "
                                 f"{rew_b[0]}, {len_b[0]}")
        say(14, f"{name}: iteration 0 equal in both variants (rew "
                f"{rew_a[0]:.6f}, len {len_a[0]:.3f})")
    say(14, f"phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return total


def main(only=None):
    """Every phase, or with `only` ("13" or "14") phases 1, 2 and that one,
    without the result lines (a quicker check of one phase; it exits
    non-zero so that it can never stand for the whole run)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    sys.path.insert(0, HERE)
    from deep_tracking_control_tpu_torch import cuda_build
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.ops import cuda_patch
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from deep_tracking_control_tpu_torch.tasks import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1: the card --------------------------------------------------
    card = card_line()
    say(1, f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
           f"{torch.cuda.device_count()}")

    # ---- 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    cuda_build.library()
    say(2, f"built {cuda_build.library_path().name} in "
           f"{time.perf_counter() - t0:.1f} s (nvcc "
           f"{cuda_build.build_seconds if cuda_build.build_seconds else 0:.1f} s)")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(2, line.strip())
    if only is not None:
        {"13": sharded_training, "14": ab_scripts}[only](card)
        raise SystemExit(f"chip_smoke: phase {only} alone passed; run "
                         "without --only for the whole run")

    # ---- 3: kernels vs plain on a real step ------------------------------
    task, train = registry.get_cfgs("lite3_dtc")
    t0 = time.perf_counter()
    env = LeggedEnv(task, device="cuda")
    runner = OnPolicyRunner(env, train)
    say(3, f"lite3_dtc: {env.num_envs} envs, terrain "
           f"{tuple(env.grid.height.shape)} from the {env.terrain.backend} "
           f"generator, set up in {time.perf_counter() - t0:.1f} s")
    # the JAX package's env builds its world with the native generator:
    # the port must build the same one, with no silent fall-back
    if env.terrain.backend != "native":
        raise AssertionError(f"terrain backend {env.terrain.backend!r}, "
                             f"expected 'native'")
    calls, runner.env_state = record_kernel_inputs(
        env, runner.env_params, runner.env_state, runner.generator)
    tables = {id(env.patch_src.blocks), id(env.patch_src.blocks16)}
    results = compare_kernels(calls, tables)

    # ---- 4: the collection path -------------------------------------------
    runner.collect()              # warm-up: allocator, cuBLAS heuristics
    torch.cuda.synchronize()
    zero_launches()
    T = train.runner.num_steps_per_env
    iter_s = []
    for it in range(ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, aux = runner.collect()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        for k, v in batch.items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"collect {it}: batch[{k}] not finite")
        if batch["obs"].shape != (T, NUM_ENVS, env.num_obs):
            raise AssertionError(f"collect {it}: obs {tuple(batch['obs'].shape)}")
        for k, v in aux.items():
            if not bool(torch.isfinite(torch.as_tensor(v)).all()):
                raise AssertionError(f"collect {it}: {k} not finite")
        # one launch per step of each kernel of the default route; none of
        # the copies or the window variant
        got = launch_counts()
        if got != expected_launches(DEFAULT_ROUTE, (it + 1) * T):
            raise AssertionError(f"launches {got} after {it + 1} collects "
                                 f"of {T} steps")
    collect_launches = launch_counts()
    steps = T * NUM_ENVS
    rate = steps * ITERS / sum(iter_s)
    say(4, f"collect: {ITERS} x {T} steps x {NUM_ENVS} envs after one "
           f"warm-up collect; iteration seconds {iter_s}; {rate:.1f} "
           f"env-steps/s ({card})")
    say(4, f"launches in the collection path: {collect_launches}; episodes "
           f"ended {float(aux['ep_count']):.0f} in the last iteration")
    results["permute_groups"] = compare_gather(runner.ppo, batch,
                                               runner.generator)
    del batch
    library_call = dict(permute_groups="index_select over the fields",
                        uniform_pm1="uniform_ on a CUDA generator")
    for k, r in results.items():
        lib = ("; no single PyTorch call computes it" if "library_ms" not in r
               else f"; {library_call[k]}: device {r['library_ms']:.4f}"
               f" ms, stream {r['library_wall_ms']:.4f} ms")
        say(4, f"{k} at {NUM_ENVS} envs: device time per call, mean of "
               f"{REPEATS}: kernel call {r['ms']:.4f} ms ({r['device_ops']:g} "
               f"device ops; its CUDA kernel alone {r['kernel_ms']:.4f} ms), "
               f"plain {r['plain_ms']:.4f} ms; stream time per call: kernel "
               f"{r['wall_ms']:.4f} ms, "
               f"plain {r['plain_wall_ms']:.4f} ms{lib}; bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({card})")
    err, same = small_reference_check(registry, LeggedEnv)
    say(4, f"16-env step on the card vs on the CPU: physics max abs err "
           f"{err:.3e} (budget 1e-4); rewards, sums, obs and privileged obs "
           f"within 1e-3 + 1e-3 rel on {same} of 16 envs")

    # ---- 5: the training path ------------------------------------------
    launches = train_path(runner, card)
    profile_phases(runner, card)

    # ---- 6: small update card vs CPU, save/load ---------------------------
    cos, rel = small_update_check()
    say(6, f"small-net update on the card vs on the CPU: gradient cosine "
           f">= {cos:.6f} (budget 0.999), stats max rel err {rel:.3e} "
           f"(budget 1e-3)")
    n = save_load_check(registry, LeggedEnv, OnPolicyRunner)
    say(6, f"save/load on the card: {n} tensors restored exactly")
    # phase 10 loads phase 5's runner from its checkpoint
    deploy_root = tempfile.mkdtemp(dir=HERE)
    atexit.register(shutil.rmtree, deploy_root, True)
    experiment = train.runner.experiment_name
    os.makedirs(os.path.join(deploy_root, experiment, "phase5"))
    runner.save(os.path.join(deploy_root, experiment, "phase5",
                             f"model_{runner.current_learning_iteration}.pt"))

    # ---- 7: the routes ----------------------------------------------
    route_slots = ((cuda_patch, "extract_patches", "extract_patches"),
                   (cuda_patch, "extract_windows", "extract_windows"),
                   (cuda_substep, "decimation_step", "decimation_step"))
    del runner
    for name, (values, kernels) in ROUTES.items():
        with route_env(values):
            t0 = time.perf_counter()
            renv = LeggedEnv(task, device="cuda")
            rrunner = OnPolicyRunner(renv, train)
            say(7, f"{name}: {renv.num_envs} envs set up in "
                   f"{time.perf_counter() - t0:.1f} s")
            calls, rrunner.env_state = record_kernel_inputs(
                renv, rrunner.env_params, rrunner.env_state,
                rrunner.generator, steps=2, slots=route_slots)
            compare_route_kernels(
                calls, {id(renv.patch_src.blocks), id(renv.patch_src.blocks16)},
                results)
            counts = route_collect(name, rrunner, kernels, card)
            for k in ("extract_patches", "extract_windows",
                      "decimation_step_window"):
                if counts[k] and not launches[k]:
                    launches[k] = counts[k]
            if values.get("DTC_STRICT_PARITY") == "1":
                strict_learn(rrunner, card)
            err, same = small_reference_check(registry, LeggedEnv)
            say(7, f"{name}: 16-env step on the card vs on the CPU: physics "
                   f"max abs err {err:.3e} (budget 1e-4); rewards, sums, obs "
                   f"and privileged obs within 1e-3 + 1e-3 rel on {same} of "
                   f"16 envs")
            del rrunner, renv, calls
            torch.cuda.empty_cache()
    for k in ("extract_patches", "extract_windows", "decimation_step_window"):
        r = results[k]
        lib = (f"; one advanced-index gather: device {r['library_ms']:.4f} "
               f"ms, stream {r['library_wall_ms']:.4f} ms"
               if "library_ms" in r else "")
        say(7, f"{k} at {NUM_ENVS} envs: device time per call, mean of "
               f"{REPEATS}: kernel call {r['ms']:.4f} ms ({r['device_ops']:g} "
               f"device ops; its CUDA kernel alone {r['kernel_ms']:.4f} ms), "
               f"plain {r['plain_ms']:.4f} ms; stream time per call: kernel "
               f"{r['wall_ms']:.4f} ms, "
               f"plain {r['plain_wall_ms']:.4f} ms{lib}; bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_by']}; {launches[k]} "
               f"launches in its route's collect ({card})")

    # ---- 8: the other tasks, and the staged X30 protocol ----------------
    for name in TASKS:
        results.update(other_task(name, registry, LeggedEnv, OnPolicyRunner,
                                  card))
    staged_protocol(registry, LeggedEnv, OnPolicyRunner, card)

    # ---- 10: the deployment path ------------------------------------------
    results.update(deployment_path(deploy_root, experiment, card))

    # ---- 11: the other policies ------------------------------------------
    other_policies(env, train, card)
    del env

    # ---- 12: more substeps, the generic FK/ABA, a three-legged robot ------
    t0 = time.perf_counter()
    substeps_route(registry, LeggedEnv, OnPolicyRunner, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    robot_root = tempfile.mkdtemp(dir=HERE)
    atexit.register(shutil.rmtree, robot_root, True)
    results.update(three_leg_route(registry, LeggedEnv, OnPolicyRunner, card,
                                   robot_root))
    torch.cuda.empty_cache()
    say(12, f"phase 12 in {time.perf_counter() - t0:.1f} s ((a) and (c) "
            f"{t1 - t0:.1f} s, (b) {time.perf_counter() - t1:.1f} s)")

    # ---- 13: the env axis sharded over torch.distributed ranks -------------
    results.update(sharded_training(card))

    # ---- 14: the A/B training-outcome scripts ------------------------------
    ab_launches = ab_scripts(card)

    # ---- 9: result lines ----------------------------------------------
    # each timed call found its inputs in HBM (`timing_probes`): a kernel
    # that reads under the time of its bytes read has them miscounted.
    # Its outputs may stay in L2 when it ends, so that it may read under
    # its bound: those rows are named.
    under = {k: (r["kernel_ms"], r["read_ms"]) for k, r in results.items()
             if r["kernel_ms"] < r["read_ms"]}
    if under:
        raise AssertionError(f"kernels under the time of their bytes read "
                             f"(kernel ms, read ms): {under}")
    for k, r in results.items():
        for what in ("ms", "kernel_ms", "plain_ms", "library_ms"):
            if r.get(what) is not None and r[what] < r["bound_ms"]:
                say(9, f"{k}: {what} {r[what]:.4f} under the bound "
                       f"{r['bound_ms']:.4f} ms (its bytes read alone "
                       f"{r['read_ms']:.4f} ms)")
    say(9, f"every kernel at or above the time of its bytes read; each "
           f"timed call after an L2 eviction ({card})")
    # the main path's kernels, then each kernel at another task's shapes
    # ("kernel (task)", with its launches in that task's collect)
    rows = list(KERNELS) + [k for k in results if k not in KERNELS]
    kernels = [dict(name=k, route="cuda", source=KERNELS[base][0],
                    replaces=KERNELS[base][1],
                    launches=results[k].get("launches", launches.get(k)),
                    max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], kernel_ms=results[k]["kernel_ms"],
                    plain_ms=results[k]["plain_ms"],
                    bound_ms=results[k]["bound_ms"],
                    bound_by=results[k]["bound_by"],
                    library_ms=results[k].get("library_ms"),
                    **(results[k].get("launch") or {}),
                    **{x: results[k][x] for x in EXTRA_KEYS
                       if x in results[k]},
                    **({"ab_launches": ab_launches[k]} if k in KERNELS
                       else {}))
               for k in rows for base in [k.split(" (")[0]]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["13", "14"], default=None,
                    help="phases 1, 2 and this one alone (exits non-zero)")
    # a rank process of phase 13 (c), started by the phase itself
    ap.add_argument("--shard-rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--store", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.shard_rank is not None:
        shard_rank_main(a.shard_rank, a.world, a.store, a.out)
    else:
        main(a.only)
