"""step_host_us_per_op: the host's unblocked time per device operation
of an env step, in us: 1e3 x step_host_ms (the unprofiled calls' dtc/env.step
spans) over step_device_ops (the traced calls' env.step ranges).  None
where either reads nothing."""
from harness import manifest


def read(run):
    ms = manifest.reader("step_host_ms")(run)
    ops = manifest.reader("step_device_ops")(run)
    if ms is None or not ops:
        return None
    return 1e3 * ms / ops
