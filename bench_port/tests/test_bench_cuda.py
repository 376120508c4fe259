"""On the card: one short run of every cell through the command, its
result line as the contract reads it.

    python -m pytest bench_port/tests/test_bench_cuda.py -q   (on the card)
"""
import json
import math
import subprocess
import sys

import pytest

from harness import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_run_line(card, name, trace):
    m = manifest.load()
    cmd = [sys.executable, str(manifest.BENCH / "run.py"), "--workload",
           name, "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace",
           str(trace)]
    out = subprocess.run(cmd, cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    cell = manifest.cell(m, name)
    want = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(line["metrics"]) == {e["name"] for e in want}
    for v in line["metrics"].values():
        assert math.isfinite(v["value"])
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        for k in ("k1_roofline", "kernels_roofline", "mfu"):
            assert 0 < line["metrics"][k]["value"] <= 100
