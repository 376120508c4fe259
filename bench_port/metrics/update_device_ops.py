"""update_device_ops: device operations launched inside the update ranges
of the traced calls, per update."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("update") or not tr.in_range("update"):
        return None
    return len(tr.in_range("update")) / tr.count("update")
