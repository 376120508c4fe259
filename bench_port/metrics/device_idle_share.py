"""device_idle_share: 100 x (1 - the device's busy seconds per traced call
(the union of the device operations' intervals inside the traced calls,
over their count) over the mean seconds of the window's unprofiled
calls), in %.  The profiler slows the host-paced parts of the traced
calls, so their own wall time would overstate the idle share."""


def read(run):
    tr = run.trace
    span = tr.span("iteration") if tr is not None else None
    n = tr.count("iteration") if span is not None else 0
    if not n or not tr.ops or not run.call_s:
        return None
    wall = sum(run.call_s) / len(run.call_s)
    return 100.0 * (1.0 - tr.busy_s(*span) / n / wall)
