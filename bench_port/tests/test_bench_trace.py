"""The per-layer metrics' arithmetic on a synthetic profiler trace."""
import pytest

from counts import kernels as kc
from harness import manifest
from harness.main import Run
from harness.trace import Trace, is_kernel


def X(cat, name, ts, dur, corr=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=0)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


K1 = "void (anonymous namespace)::substep_kernel<true>(Params)"
K9 = "(anonymous namespace)::gather_kernel(int, float const*)"


def synthetic():
    """One traced iteration, us: collect [0, 400] holding act [10, 50] and
    env.step [60, 300]; update [450, 950]; the iteration [0, 1000]."""
    ev = [X("user_annotation", "iteration", 0, 1000),
          X("user_annotation", "collect", 0, 400),
          X("user_annotation", "act", 10, 40),
          X("user_annotation", "env.step", 60, 240),
          X("user_annotation", "update", 450, 500)]
    launches = [(1, 20), (2, 70), (3, 80), (4, 500), (5, 510)]
    ev += [X("cuda_runtime", "cudaLaunchKernel", t, 2, c) for c, t in launches]
    ev += [X("kernel", "gemm", 30, 20, 1),          # act: 20 us
           X("kernel", K1, 100, 50, 2),             # env.step: 50 + 30
           X("gpu_memcpy", "Memcpy DtoD", 160, 30, 3),
           X("kernel", K9, 520, 100, 4),            # update: 100 + 200
           X("kernel", "gemm", 600, 200, 5),
           X("kernel", "stray", 990, 5, 99)]        # launch not in the trace
    return Trace.from_events(ev)


def run_of(trace, num_envs=1024):
    m = manifest.load()
    cell = manifest.cell(m, m["workloads"][0]["name"])
    return Run(cell=cell, mix=cell["mix"], num_envs=num_envs, env_steps=1,
               setup_s=1.0, window_s=1.0, calls=1, rows=[],
               peak_window_bytes=0, call_s=[1e-3], trace=trace)


def test_ranges_and_busy():
    tr = synthetic()
    assert tr.count("env.step") == 1 and tr.count("update") == 1
    assert tr.device_s("act") == pytest.approx(20e-6)
    assert tr.device_s("env.step") == pytest.approx(80e-6)
    assert tr.device_s("update") == pytest.approx(300e-6)
    assert tr.device_s("collect") == pytest.approx(100e-6)
    assert len(tr.in_range("env.step")) == 2
    # union of [30,50], [100,150], [160,190], [520,620], [600,800], [990,995]
    assert tr.busy_s(0, 1000) == pytest.approx((20 + 50 + 30 + 280 + 5) * 1e-6)
    gaps = tr.gaps(0, 1000)
    assert sum(d for _, d in gaps) == pytest.approx(1000 - 385)
    idle = dict(map(tuple, tr.idle_by_host(0, 1000, ("iteration", "collect",
                                                      "act", "env.step",
                                                      "update"))))
    # each gap goes to where the host was as it began: [0, 30] collect,
    # [50, 100] act, [150, 160] and [190, 520] env.step, [800, 990]
    # update, [995, 1000] the iteration
    assert idle == pytest.approx({
        "iteration>collect": 30e-6, "iteration>collect>act": 50e-6,
        "iteration>collect>env.step": 340e-6, "iteration>update": 190e-6,
        "iteration": 5e-6})
    assert tr.top_ops(2)[0] == ["gemm", pytest.approx(220e-6)]


def test_readers():
    tr = synthetic()
    run = run_of(tr)
    read = {n: manifest.reader(n)(run) for n in (
        "step_device_ms", "step_device_ops", "act_device_ms",
        "update_device_ms", "update_device_ops", "device_idle_share",
        "k1_roofline", "kernels_roofline", "collect_ms", "mfu",
        "peak_device_gib")}
    assert read["step_device_ms"] == pytest.approx(0.08)
    assert read["step_device_ops"] == 2
    assert read["act_device_ms"] == pytest.approx(0.02)
    assert read["update_device_ms"] == pytest.approx(0.3)
    assert read["update_device_ops"] == 2
    # 385 us busy in the one traced call, over the unprofiled calls' mean
    assert read["device_idle_share"] == pytest.approx(61.5)
    run.call_s = [0.5e-3, 1.5e-3, 2e-3]
    assert manifest.reader("device_idle_share")(run) == pytest.approx(
        100 * (1 - 385e-6 / (4e-3 / 3)))
    counts = kc.table()["lite3_dtc"]
    b1 = kc.bound_s(**kc.launch(counts["K1"], 1024))
    b9 = kc.bound_s(**kc.launch(counts["K9"], 1024))
    assert read["k1_roofline"] == pytest.approx(100 * b1 / 50e-6)
    assert read["kernels_roofline"] == pytest.approx(
        100 * (b1 + b9) / 150e-6)
    # nothing to read: no rows, no peak
    assert read["collect_ms"] is None and read["mfu"] is None
    assert read["peak_device_gib"] is None


def test_readers_without_device_ops():
    tr = Trace.from_events([X("user_annotation", "iteration", 0, 10),
                            X("user_annotation", "env.step", 0, 5)])
    run = run_of(tr)
    for n in ("step_device_ms", "device_idle_share", "k1_roofline",
              "kernels_roofline"):
        assert manifest.reader(n)(run) is None


def test_rows():
    run = run_of(None)
    run.rows = [dict(collection_time=0.2, learning_time=0.6),
                dict(collection_time=0.4, learning_time=0.8)]
    assert manifest.reader("collect_ms")(run) == pytest.approx(300.0)
    assert manifest.reader("update_ms")(run) == pytest.approx(700.0)
    from counts import flops
    per = flops.iteration(run.cell["config_file"], run.num_envs)
    assert manifest.reader("mfu")(run) == pytest.approx(
        100 * per * 2 / 2.0 / kc.PEAK_BF16_FLOPS_S)
    run.calls, run.env_steps, run.window_s = 3, 1000, 2.0
    assert manifest.reader("env_steps_per_s")(run) == pytest.approx(1500.0)


def test_kernel_names():
    assert is_kernel(K1, "substep_kernel")
    assert is_kernel("substep_kernel(float*)", "substep_kernel")
    assert not is_kernel("void big_substep_kernel<1>()", "substep_kernel")
    assert not is_kernel("(anonymous namespace)::substep_kernels(int)",
                         "substep_kernel")
