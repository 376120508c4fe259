"""Roofline shares of the port's kernels from a traced run: each launch's
least time from the frozen counts (counts/kernels.py) at the cell's env
count, summed over the launches the trace holds, over their summed
measured time."""
from __future__ import annotations

from counts import kernels as kc

from .trace import is_kernel


def share(run, names) -> float | None:
    """100 x sum of bounds / sum of measured times over the launches of
    the kernels `names` (K-numbers) in run.trace; None without any, or
    without counts for the configuration."""
    tr = run.trace
    counts = kc.for_config(run.cell["config"]["name"],
                           run.cell["config_file"])
    if tr is None or counts is None:
        return None
    bound = spent = 0.0
    for k in names:
        if k not in counts:
            continue
        symbol = kc.KERNELS[k][1]
        ops = [o for o in tr.ops if is_kernel(o.name, symbol)]
        if not ops:
            continue
        one = kc.bound_s(**kc.launch(counts[k], run.num_envs))
        bound += one * len(ops)
        spent += sum(o.dur for o in ops) * 1e-6
    return 100.0 * bound / spent if spent > 0 else None
