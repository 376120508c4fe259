"""The readings that the limits of bench_port/limits/<cell>.json are set
from: the numbers of `correct` for sound runs of the program on many
seeds, and for stand-ins judged in the program's place: the control (the
reference with every bf16 product's operands rounded to float8 and every
float32 product's to TF32), the witness (the reference with every
product's inner width padded to a multiple of 8 and its bias added in the
product's epilogue: a sound rewrite, the same sums in another order), the
update's half-batch fault (each minibatch's second half left out; its
second half of envs in a recurrent update) and the env step's faults (its
state returned unchanged; half the envs left unstepped).

    python bench_port/readings.py --workload NAME --seeds 1 2 3 \\
        [--stand-ins control witness half_batch step_unchanged step_half] \\
        [--num-envs N] [--device cuda]

One process for all seeds (the kernels are built once); each seed builds
its program, runs the checked calls and one call of the window, and is
judged.  Prints one JSON line a seed, with the set-up and check seconds,
the device, and the rate and device memory peak of that one call.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import main as hm  # noqa: E402
from harness import manifest  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--stand-ins", nargs="*", default=())
    ap.add_argument("--num-envs", type=int)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    cell = manifest.cell(manifest.load(), args.workload)
    over = {} if args.num_envs is None else dict(num_envs=args.num_envs)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, nums, others, dev = hm.run_cell(
            cell, seed, 0.0, False, args.device, t0, mix_override=over,
            stand_ins=tuple(args.stand_ins))
        print(json.dumps(dict(
            seed=seed, numbers=nums, stand_ins=others, setup_s=run.setup_s,
            check_s=run.extra["check_s"], device=dev,
            **{m: manifest.reader(m)(run) for m in
               ("env_steps_per_s", "peak_device_gib")})), flush=True)


if __name__ == "__main__":
    main()
