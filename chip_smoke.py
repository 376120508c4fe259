#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure ends the run non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the CUDA kernels from deep_tracking_control_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the inputs of a real
     lite3_dtc step at 4096 envs, with the kernel and plain times;
  4. the main path: LeggedEnv(lite3_dtc, 4096 envs) + ActorCriticDecoder +
     OnPolicyRunner, 3 collect() iterations of 24 steps, every launch
     counted; then one step of a small env on the card against the same
     step on the CPU (the plain versions);
  5. a JSON line of the kernels, the nvidia-smi line, and the result line.
Weights are random (seeded); nothing is downloaded.  Needs a CUDA device:
without one it stops before printing any result.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NUM_ENVS = 4096
ITERS = 3
REPEATS = 20

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "decimation_step": ("deep_tracking_control_tpu_torch/csrc/substep.cu",
                        "deep_tracking_control_tpu/physics/pallas_substep.py:650"),
    "sample_all": ("deep_tracking_control_tpu_torch/csrc/sampler.cu",
                   "deep_tracking_control_tpu/terrain/pallas_sampler.py:150"),
    "plan_footholds": ("deep_tracking_control_tpu_torch/csrc/planner.cu",
                       "deep_tracking_control_tpu/env/pallas_planner.py:133"),
}


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


def device_ms(torch, fn, repeats=REPEATS):
    """Median over `repeats` calls of the device time of all the work one
    fn() call queues (torch.profiler, CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per_call.append(sum(e.self_device_time_total
                            for e in prof.key_averages()) / 1e3)
    per_call.sort()
    if per_call[-1] <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return per_call[len(per_call) // 2]


def timings(torch, kernel, plain, plain_repeats=REPEATS):
    return dict(ms=device_ms(torch, kernel),
                plain_ms=device_ms(torch, plain, plain_repeats),
                wall_ms=wall_ms(torch, kernel),
                plain_wall_ms=wall_ms(torch, plain, plain_repeats))


def record_kernel_inputs(env, params, state, gen, steps=3):
    """Run `steps` env steps and keep the arguments each kernel got in the
    last one (the wrappers are wrapped, then restored)."""
    import torch
    from deep_tracking_control_tpu_torch.env import cuda_planner
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    calls = {}
    originals = (cuda_substep.decimation_step, cuda_sampler.sample_all,
                 cuda_planner.select_footholds)

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return wrapped
    cuda_substep.decimation_step = recorder("decimation_step", originals[0])
    cuda_sampler.sample_all = recorder("sample_all", originals[1])
    cuda_planner.select_footholds = recorder("plan_footholds", originals[2])
    try:
        for _ in range(steps):
            actions = 0.3 * torch.randn((env.num_envs, env.num_actions),
                                        generator=gen, device=env.device)
            state, _ = env.step(params, state, actions, gen)
    finally:
        (cuda_substep.decimation_step, cuda_sampler.sample_all,
         cuda_planner.select_footholds) = originals
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


def compare_kernels(calls):
    """Phase 3: each kernel vs its plain version on recorded inputs."""
    import torch
    from deep_tracking_control_tpu_torch.env import cuda_planner
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
    results = {}

    # K1: one policy step of physics.  Budget 1e-4: FMA contraction and
    # rsqrtf in the kernel round differently from the plain op chain, and
    # four substeps of stiff contact carry the difference.
    args, kwargs = calls["decimation_step"]
    kw = {k: v for k, v in kwargs.items() if k != "consts"}
    phys, anchors, info = cuda_substep.decimation_step(*args, **kwargs)
    pphys, panchors, pinfo = cuda_substep.decimation_step_plain(*args, **kw)
    for k in phys:
        check_close(f"decimation_step {k}", phys[k], pphys[k], 1e-4, 1e-4)
    check_close("decimation_step anchors", anchors, panchors, 1e-4, 1e-4)
    for k in ("foot_pos", "foot_vel", "thigh_pos", "body_pts", "torques"):
        check_close(f"decimation_step {k}", info[k], pinfo[k], 1e-4, 1e-4)
    # contact forces come from 12 kN/m springs: 1e-6 m is 1e-2 N
    check_close("decimation_step contact_forces", info["contact_forces"],
                pinfo["contact_forces"], 1e-2, 1e-4)
    err = max_err([(phys[k], pphys[k]) for k in phys]
                  + [(anchors, panchors)])
    results["decimation_step"] = dict(max_abs_err=err, **timings(
        torch, lambda: cuda_substep.decimation_step(*args, **kwargs),
        lambda: cuda_substep.decimation_step_plain(*args, **kw), 5))
    say(3, f"decimation_step vs plain: max abs err {err:.3e} "
           f"(budget 1e-4 + 1e-4 rel; contact forces 1e-2 N)")

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
    results["sample_all"] = dict(max_abs_err=err, **timings(
        torch, lambda: cuda_sampler.sample_all(*args),
        lambda: cuda_sampler.sample_all_plain(*args)))
    say(3, f"sample_all vs plain: nearest exact, max abs err {err:.3e} "
           f"(budget 1e-5 heights, 1e-4 slopes)")

    # K3: selections may differ in <= 2% of envs, and only at near-ties
    (scal, heights, stat, ny), _ = calls["plan_footholds"]
    got = cuda_planner.select_footholds(scal, heights, stat, ny)
    want = cuda_planner.plan_plain(scal, heights, stat, ny)
    total, raw, hwx, hwy = cuda_planner.plan_objective(scal, heights, stat, ny)
    differ = (got != want).any(dim=1)
    frac = float(differ.float().mean())
    if frac > 0.02:
        raise AssertionError(f"plan_footholds: {frac:.2%} of envs differ")
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
    err = max_err([(got[~differ], want[~differ])]) if (~differ).any() else 0.0
    results["plan_footholds"] = dict(max_abs_err=err, **timings(
        torch, lambda: cuda_planner.select_footholds(scal, heights, stat, ny),
        lambda: cuda_planner.plan_plain(scal, heights, stat, ny)))
    say(3, f"plan_footholds vs plain: {frac:.3%} of envs differ (budget 2%, "
           f"near-ties only); max abs err elsewhere {err:.3e}")
    return results


def small_reference_check(registry, LeggedEnv, device="cuda"):
    """One step of a 16-env lite3_dtc on the card against the same step on
    the CPU (plain versions), from the same state and draws."""
    import dataclasses
    import torch
    task, _ = registry.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=16),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    genv = LeggedEnv(task, device=device)
    cenv = LeggedEnv(task, device="cpu")
    cgen = torch.Generator().manual_seed(5)
    cparams, cstate = cenv.init(cgen)
    for _ in range(2):
        cstate, _ = cenv.step(cparams, cstate, torch.zeros(16, 12), cgen)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.to(dev).clone()
        return tree
    gstate = to(cstate, genv.device)
    gparams = dict(to({k: v for k, v in cparams.items() if k != "terrain"},
                      genv.device), terrain=genv.patch_src)
    draws = dict(lag=torch.tensor([2, 1, 3, 4]),
                 height_noise=torch.rand((16, cenv.num_height_points),
                                         generator=cgen) * 2 - 1,
                 obs_noise=torch.rand((16, cenv.num_obs), generator=cgen) * 2 - 1)
    actions = 0.3 * torch.randn((16, 12), generator=cgen)
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
    # obs without the foothold block (a near-tie may pick another cell)
    check_close("small step obs", go["obs"][keep, :45].cpu(),
                co["obs"][keep, :45], 1e-3, 1e-3)
    return err


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    sys.path.insert(0, HERE)
    from deep_tracking_control_tpu_torch import cuda_build
    from deep_tracking_control_tpu_torch.env import cuda_planner
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.physics import cuda_substep
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from deep_tracking_control_tpu_torch.tasks import registry
    from deep_tracking_control_tpu_torch.terrain import cuda_sampler
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

    # ---- 3: kernels vs plain on a real step ------------------------------
    task, train = registry.get_cfgs("lite3_dtc")
    t0 = time.perf_counter()
    env = LeggedEnv(task, device="cuda")
    runner = OnPolicyRunner(env, train)
    say(3, f"lite3_dtc: {env.num_envs} envs, terrain "
           f"{tuple(env.grid.height.shape)}, set up in "
           f"{time.perf_counter() - t0:.1f} s")
    calls, runner.env_state = record_kernel_inputs(
        env, runner.env_params, runner.env_state, runner.generator)
    results = compare_kernels(calls)

    # ---- 4: the main path -------------------------------------------------
    runner.collect()              # warm-up: allocator, cuBLAS heuristics
    torch.cuda.synchronize()
    counters = {"decimation_step": cuda_substep.decimation_step,
                "sample_all": cuda_sampler.sample_all,
                "plan_footholds": cuda_planner.plan_footholds_fused}
    for fn in counters.values():
        fn.launches = 0
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
        for k, fn in counters.items():         # one launch per step
            if fn.launches != (it + 1) * T:
                raise AssertionError(f"{k}: {fn.launches} launches after "
                                     f"{it + 1} collects of {T} steps")
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = T * NUM_ENVS
    rate = steps * ITERS / sum(iter_s)
    say(4, f"collect: {ITERS} x {T} steps x {NUM_ENVS} envs after one "
           f"warm-up collect; iteration seconds {iter_s}; {rate:.1f} "
           f"env-steps/s ({card})")
    say(4, f"launches in the main path: {launches}; episodes ended "
           f"{float(aux['ep_count']):.0f} in the last iteration")
    for k, r in results.items():
        say(4, f"{k} at {NUM_ENVS} envs: device time per call, median of "
               f"{REPEATS}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
               f" ms; stream time per call: kernel {r['wall_ms']:.4f} ms, "
               f"plain {r['plain_wall_ms']:.4f} ms ({card})")
    err = small_reference_check(registry, LeggedEnv)
    say(4, f"16-env step on the card vs on the CPU: max abs err {err:.3e} "
           f"(budget 1e-4)")

    # ---- 5: result lines ----------------------------------------------
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1], launches=launches[k],
                    max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
               for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
