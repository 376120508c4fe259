"""Device time of the physics decimation kernel (fused and window
variants, on the same inputs) and of the planner kernel at the inputs of
a real lite3_dtc step, at several block sizes of the physics kernel.

    python deep_tracking_control_tpu_torch/scripts/kernel_times.py \
        [--threads 32 64 128] [--num_envs 4096] [--repeats 20]

Needs a CUDA device.  Each block size is set on
`physics.cuda_substep.THREADS` before its calls; every result is held to
its plain version (K1 1e-4 + 1e-4 rel, contact forces 1e-2 N; the window
variant bit for bit the fused one; the planner at most 2% of envs
differing, near-ties only) before it is timed.  The helpers (inputs,
checks, timing) come from chip_smoke.py at the root of this checkout.
Prints the card, the compiler's registers and stack of each kernel, one
line per block size, and a JSON line last.
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
    from deep_tracking_control_tpu_torch.env import cuda_planner
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.ops import cuda_patch
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.tasks import registry
    card = cs.card_line()
    print(f"[kernel_times] card {card}", flush=True)
    cuda_build.build()
    for line in cuda_build.build_log.splitlines():
        if any(w in line for w in ("registers", "stack", "Compiling entry")):
            print(f"[kernel_times] {line.strip()}", flush=True)

    task, _ = registry.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=args.num_envs))
    t0 = time.perf_counter()
    env = LeggedEnv(task, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    params, state = env.init(gen)
    calls, _ = cs.record_kernel_inputs(env, params, state, gen)
    print(f"[kernel_times] {env.num_envs} envs set up and stepped in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
    results = []
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
                   ms=cs.device_ms(torch, k1, args.repeats),
                   window_ms=cs.device_ms(torch, k1w, args.repeats))
        results.append(row)
        print(f"[kernel_times] K1 at {threads} threads a block: "
              f"{row['ms']:.4f} ms, K1w {row['window_ms']:.4f} ms (device "
              f"time, mean of {args.repeats}; {card})", flush=True)
    cuda_substep.THREADS = default

    (scal, heights, stat, ny), _ = calls["plan_footholds"]
    want3 = cuda_planner.plan_plain(scal, heights, stat, ny)

    def k3():
        return cuda_planner.select_footholds(scal, heights, stat, ny)
    frac = float(cs.check_planner(k3(), want3, scal, heights, stat, ny)
                 .float().mean())
    row = dict(kernel="plan_footholds", differ=frac,
               ms=cs.device_ms(torch, k3, args.repeats))
    results.append(row)
    print(f"[kernel_times] K3: {row['ms']:.4f} ms ({frac:.3%} of envs "
          f"differ from plain; {card})", flush=True)

    print(json.dumps(dict(card=card, num_envs=env.num_envs,
                          results=results)))


if __name__ == "__main__":
    main()
