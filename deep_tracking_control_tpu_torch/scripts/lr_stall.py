"""The learning-rate floor reading of training runs, from the log lines
that runner/train.py prints every LOG_INTERVAL iterations
(`it N | fps F | rew R | len L | vloss V | surr S | lr X`).

For each run: the first logged iteration at which lr reads the adaptive
rule's 1e-5 floor, whether every later logged lr reads it too, and
whether the run stalled: lr at the floor at every logged iteration from
some point to the end, and a mean episode length under STALL_LEN at the
last logged iteration; then rew and len at iterations 0, 100, 200 and the
last logged one.

    python -m deep_tracking_control_tpu_torch.scripts.lr_stall LOG [LOG ...]

A log of the A/B scripts holds two runs, each after its `=== ... ===`
line; a log of scripts/train.py one.
"""
from __future__ import annotations

import math
import re
import sys

FLOOR = "1.0e-05"          # the floor as the log line prints it
STALL_LEN = 50.0
READ_AT = (0, 100, 200)
LINE = re.compile(r"^it\s+(\d+) \|.*\| rew\s+(\S+) \| len\s+(\S+) \|.*"
                  r"\| lr (\S+)\s*$")


def split_runs(lines, name="run"):
    """[(run name, [(it, rew, len, lr text), ...]), ...]: a new run at
    every `=== ... ===` line, the log lines of each in order."""
    runs, label = [], name
    for line in lines:
        s = line.strip()
        if s.startswith("===") and s.endswith("==="):
            label = s.strip("= ")
            runs.append((label, []))
            continue
        m = LINE.match(s)
        if m:
            if not runs:
                runs.append((label, []))
            runs[-1][1].append((int(m[1]), float(m[2]), float(m[3]), m[4]))
    return [r for r in runs if r[1]]


def reading(points):
    """The floor reading of one run's logged points."""
    at_floor = [lr == FLOOR for _, _, _, lr in points]
    first = next((p[0] for p, f in zip(points, at_floor) if f), None)
    stays = first is not None and all(
        f for p, f in zip(points, at_floor) if p[0] >= first)
    # the start of the trailing stretch at the floor, if the run ends there
    tail = None
    for p, f in zip(reversed(points), reversed(at_floor)):
        if not f:
            break
        tail = p[0]
    last = points[-1]
    by_it = {p[0]: p for p in points}
    return dict(first_floor=first, stays=stays, floor_from=tail,
                stalled=tail is not None and last[2] < STALL_LEN,
                last_it=last[0],
                read={it: (by_it[it][1], by_it[it][2]) if it in by_it
                      else (math.nan, math.nan)
                      for it in READ_AT + (last[0],)})


def main(argv=None):
    paths = sys.argv[1:] if argv is None else argv
    for path in paths:
        with open(path) as f:
            runs = split_runs(f, name=path)
        for label, points in runs:
            r = reading(points)
            cells = "  ".join(f"it {it}: rew {rew:.3f} len {ln:.1f}"
                              for it, (rew, ln) in r["read"].items())
            print(f"{path} [{label}]: first lr at the floor "
                  f"{r['first_floor']}, stays to the end {r['stays']}, "
                  f"at the floor from {r['floor_from']} to {r['last_it']}, "
                  f"stalled {r['stalled']}; {cells}", flush=True)


if __name__ == "__main__":
    main()
