"""sync_wait_ms: the host's time blocked in the port's dtc/sync/* spans
(implicit and explicit host-device syncs), per unprofiled window call,
in ms.  None where the rows carry no "trace"."""


def read(run):
    tr = [r["trace"] for r in run.rows if "trace" in r]
    if not tr:
        return None
    return 1e3 * sum(a["wait_s"] for t in tr for n, a in t["spans"].items()
                     if n.startswith("dtc/sync/")) / len(tr)
