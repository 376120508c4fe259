"""update_ms: the mean of the unprofiled window calls' synchronized
learning_time (the update and the stats' fetch), in ms."""


def read(run):
    t = [r["learning_time"] for r in run.rows if "learning_time" in r]
    return 1e3 * sum(t) / len(t) if t else None
