"""Device time of the physics decimation kernel K1 (fused and window
variants, on the same inputs) at several block sizes, and of the terrain
sampler K2, the planner K3, the reward kernel K6, the obs kernel K7 and
the noise kernel K8, at the inputs of a real lite3_dtc step.

    python deep_tracking_control_tpu_torch/scripts/kernel_times.py \
        [--threads 32 64 128] [--num_envs 4096] [--repeats 20] \
        [--save FILE | --load FILE]

Needs a CUDA device.  K1's block size is set on
`physics.cuda_substep.THREADS` before its calls; K2's and K6's launch
shapes are constants of their kernels.  Every result is held to its
plain version before it is timed (K1 1e-4 + 1e-4 rel, contact forces
1e-2 N; the window variant bit for bit the fused one; K2 nearest exact,
bilinear 1e-5, slopes 1e-4; K3 at most 2% of envs differing, near-ties
only; K6 the budgets of chip_smoke.py; K7 1e-6 against its plain
version fed K8's draws for the step's seed; K8 bit for bit).  Each row gives the call's device
ms (all the work the wrapper queues) and its CUDA kernel's alone, each
call after a read that evicts L2 (chip_smoke.py `device_profile`).  Then
the plane fit of the orientation terms as the plain version's matrix
product, and K8 at the step's reset shape beside its launch floors: an
empty kernel and one that only loads the seed, at K8's launch shape
(csrc/probe.cu).  K7's and K8's launches, as the profiler recorded them,
must be the shapes their wrappers state (`launch_shape`).

`--save FILE` keeps the recorded step's kernel inputs (torch.save) and
`--load FILE` times on inputs kept so: a kernel's redesign times its
parent on the same inputs in the same call (copy this file and
chip_smoke.py into the parent's checkout, then `--load` there the
inputs this checkout saved).
The helpers (inputs, checks, timing) come from chip_smoke.py at the root
of this checkout.  Prints the card, the compiler's registers and stack of
each kernel, one line per shape, and a JSON line last.
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time


def main():
    own = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="*", default=None)
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--save", default=None)
    ap.add_argument("--load", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    sys.path.insert(0, own)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(own, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deep_tracking_control_tpu_torch import cuda_build
    from deep_tracking_control_tpu_torch.env import (cuda_obs, cuda_planner,
                                                     cuda_rewards)
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.ops import cuda_patch, cuda_rng
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.tasks import registry
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"[kernel_times] card {card}; checkout {own}", flush=True)
    cuda_build.build()
    for line in cuda_build.build_log.splitlines():
        if any(w in line for w in ("registers", "stack", "Compiling entry")):
            print(f"[kernel_times] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    if args.load:
        calls = torch.load(args.load, weights_only=False)
        source = f"inputs loaded from {args.load}"
    else:
        task, _ = registry.get_cfgs("lite3_dtc")
        task = dataclasses.replace(
            task, env=dataclasses.replace(task.env, num_envs=args.num_envs))
        env = LeggedEnv(task, device="cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        params, state = env.init(gen)
        calls, _ = cs.record_kernel_inputs(env, params, state, gen)
        source = (f"{env.num_envs} envs on the {env.terrain.backend} "
                  f"terrain, set up and stepped")
        if args.save:
            torch.save(calls, args.save)
            source += f", inputs saved to {args.save}"
    print(f"[kernel_times] {source} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    results = []

    def split(name, fn):
        call, kernel, ops, others, launch = cs.device_split(
            torch, fn, cs.SYMBOLS[name], args.repeats)
        return dict(call_ms=call, kernel_ms=kernel, device_ops=ops,
                    others=[k[:80] for k in others], launch=launch)

    # K1 and K1w at each block size
    k1_args, k1_kw = calls["decimation_step"]
    plain_kw = {k: v for k, v in k1_kw.items() if k != "consts"}
    blocks, starts = k1_args[18], k1_args[19]
    window = cuda_patch.extract_windows(blocks, starts)

    def k1():
        return cuda_substep.decimation_step(*k1_args, **k1_kw)

    def k1w():
        return cuda_substep.decimation_step(*k1_args[:18], None, None,
                                            consts=k1_kw["consts"],
                                            window=window)
    plain = cuda_substep.decimation_step_plain(*k1_args, **plain_kw)
    want = dict(plain[0], anchors=plain[1], **plain[2])
    default = cuda_substep.THREADS
    for threads in args.threads or [default]:
        cuda_substep.THREADS = threads
        fused, win = k1(), k1w()
        got = dict(fused[0], anchors=fused[1], **fused[2])
        gotw = dict(win[0], anchors=win[1], **win[2])
        torch.cuda.synchronize()
        for k, v in got.items():
            cs.check_close(f"K1 {k}", v, want[k],
                           1e-2 if k == "contact_forces" else 1e-4, 1e-4)
            if not torch.equal(gotw[k], v):
                raise AssertionError(f"K1w {k}: differs from K1")
        row = dict(kernel="decimation_step", threads=threads,
                   **split("decimation_step", k1),
                   window=split("decimation_step_window", k1w))
        results.append(row)
        print(f"[kernel_times] K1 at {threads} threads a block: call "
              f"{row['call_ms']:.4f} ms (kernel alone {row['kernel_ms']:.4f}"
              f"), K1w call {row['window']['call_ms']:.4f} ms (kernel alone "
              f"{row['window']['kernel_ms']:.4f}) (device time, mean of "
              f"{args.repeats}; {card})", flush=True)
    cuda_substep.THREADS = default

    # K2
    k2_args, _ = calls["sample_all"]
    ph, pgx, pgy = cuda_sampler.sample_all_plain(*k2_args)
    near = cuda_sampler.Q_MIN3 + cuda_sampler.Q_MAX10
    h, gx, gy = cuda_sampler.sample_all(*k2_args)
    torch.cuda.synchronize()
    if not torch.equal(h[:, :near], ph[:, :near]):
        raise AssertionError("K2: nearest samples differ")
    cs.check_close("K2 bilinear", h[:, near:], ph[:, near:], 1e-5, 0.0)
    cs.check_close("K2 gx", gx, pgx, 1e-4, 0.0)
    cs.check_close("K2 gy", gy, pgy, 1e-4, 0.0)
    row = dict(kernel="sample_all", **split(
        "sample_all", lambda: cuda_sampler.sample_all(*k2_args)))
    results.append(row)
    print(f"[kernel_times] K2: call {row['call_ms']:.4f} ms "
          f"({row['device_ops']:g} device ops), kernel alone "
          f"{row['kernel_ms']:.4f} ms (device time, mean of {args.repeats};"
          f" {card}); other ops {row['others']}", flush=True)

    # K3
    (scal, heights, stat, ny), _ = calls["plan_footholds"]
    want3 = cuda_planner.plan_plain(scal, heights, stat, ny)

    def k3():
        return cuda_planner.select_footholds(scal, heights, stat, ny)
    frac = float(cs.check_planner(k3(), want3, scal, heights, stat, ny)
                 .float().mean())
    row = dict(kernel="plan_footholds", differ=frac,
               **split("plan_footholds", k3))
    results.append(row)
    print(f"[kernel_times] K3: call {row['call_ms']:.4f} ms (kernel alone "
          f"{row['kernel_ms']:.4f}; {frac:.3%} of envs differ from plain; "
          f"{card})", flush=True)

    # K6 on the step's inputs (the sums it adds to are a scratch copy)
    k6_args, _ = calls["compute_rewards"]
    *head, sums = k6_args
    scratch = sums.clone()
    err = cs.check_rewards("K6", k6_args)
    row = dict(kernel="compute_rewards", max_abs_err=err,
               **split("compute_rewards", lambda: cuda_rewards
                       .compute_rewards_fused(*head, scratch)))
    results.append(row)
    print(f"[kernel_times] K6: call {row['call_ms']:.4f} ms "
          f"({row['device_ops']:g} device ops), kernel alone "
          f"{row['kernel_ms']:.4f} ms; max abs err {err:.3e} (device time, "
          f"mean of {args.repeats}; {card}); other ops {row['others']}",
          flush=True)
    # the plane fit of the orientation terms as the plain version computes
    # it: one matrix product on the step's scan view
    ctx = head[2]
    row = dict(kernel="plane_fit_matmul", ms=cs.device_ms(
        torch, lambda: ctx["measured_heights"] @ ctx["plane_pinv"].T,
        args.repeats))
    results.append(row)
    print(f"[kernel_times] the plane fit as a matrix product "
          f"{tuple(ctx['measured_heights'].shape)} x "
          f"{tuple(ctx['plane_pinv'].T.shape)}: {row['ms']:.4f} ms",
          flush=True)

    # K7 on the step's inputs, with its launch as the timing session
    # recorded it (held to the wrapper's shape) and ptxas's registers and
    # stack from the build log
    k7_args, _ = calls["compute_observations"]
    n = k7_args[10].shape[0]
    err = cs.check_observations(k7_args)[0]
    shape = cuda_obs.launch_shape(n)
    usage = sorted(cs.ptxas_usage(cs.SYMBOLS["compute_observations"]).values())
    row = dict(kernel="compute_observations", ptxas=usage, max_abs_err=err,
               **split("compute_observations",
                       lambda: cuda_obs.compute_observations_fused(*k7_args)))
    cs.check_launch("K7", row["launch"], *shape[:2])
    results.append(row)
    print(f"[kernel_times] K7: call {row['call_ms']:.4f} ms "
          f"({row['device_ops']:g} device ops), kernel alone "
          f"{row['kernel_ms']:.4f} ms; max abs err {err:.3e} against the "
          f"plain version fed K8's draws (budget 1e-6); recorded launch "
          f"{row['launch']}, the wrapper's {cs.shape_text(shape)}; build "
          f"log's ptxas (registers, stack bytes) "
          f"{usage or 'not in the build log'} (device time, mean of "
          f"{args.repeats}; {card}); other ops {row['others']}", flush=True)

    # K8 at the step's reset shape, beside its launch floors
    (seed, shape), _ = calls["uniform_pm1"]
    shape = tuple(shape)
    if not torch.equal(cuda_rng.uniform_pm1(seed, shape),
                       cuda_rng.uniform_pm1_plain(seed, shape)):
        raise AssertionError(f"K8 {shape}: differs from plain")
    row = dict(kernel="uniform_pm1", shape=list(shape), **split(
        "uniform_pm1", lambda: cuda_rng.uniform_pm1(seed, shape)))
    blocks, threads = cuda_rng.launch_shape(shape[0] * shape[1])
    cs.check_launch("K8", row["launch"], blocks, threads)
    floors = row["floors"] = cs.launch_floors(torch, seed, blocks, threads,
                                              args.repeats)
    results.append(row)
    print(f"[kernel_times] K8 at {shape} (recorded launch {blocks} blocks x "
          f"{threads} threads): call {row['call_ms']:.4f} ms, kernel alone "
          f"{row['kernel_ms']:.4f} ms; launch floors empty "
          f"{floors['empty']:.4f} ms, seed load {floors['seed_load']:.4f} ms "
          f"(the kernel {row['kernel_ms'] / floors['seed_load']:.2f}x the "
          f"seed load) (device time, mean of {args.repeats}; {card})",
          flush=True)

    print(json.dumps(dict(card=card, checkout=own, inputs=source,
                          results=results)))


if __name__ == "__main__":
    main()
