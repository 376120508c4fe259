"""host_syncs: the port's host-device syncs (implicit and explicit) per
unprofiled window call, as its tracer counts them.  None where the rows
carry no "trace"."""


def read(run):
    tr = [r["trace"] for r in run.rows if "trace" in r]
    if not tr:
        return None
    return sum(t["syncs"] + t["explicit_syncs"] for t in tr) / len(tr)
