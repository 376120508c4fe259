"""The benchmark of deep_tracking_control_tpu_torch (BENCHMARK.json).

    python bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with the cell's CUDA
devices; prints one JSON line last (harness/main.py says what it holds).
"""
import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T0))
