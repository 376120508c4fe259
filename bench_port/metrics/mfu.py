"""mfu: the model FLOPs of a call (counts/flops.py, from the
configuration's widths) times the unprofiled window calls, over their
synchronized seconds, over the H100's dense bf16 peak, in %."""
from counts import flops
from counts.kernels import PEAK_BF16_FLOPS_S


def read(run):
    t = [r["collection_time"] + r["learning_time"] for r in run.rows
         if "learning_time" in r]
    if not t:
        return None
    per_call = flops.iteration(run.cell["config_file"], run.num_envs,
                               update=run.mix["phase"] == "train")
    return 100.0 * per_call * len(t) / sum(t) / PEAK_BF16_FLOPS_S
