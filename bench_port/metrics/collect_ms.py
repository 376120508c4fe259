"""collect_ms: the mean of the unprofiled window calls' synchronized
collection_time (runner/train.py `learn` rows), in ms."""


def read(run):
    t = [r["collection_time"] for r in run.rows if "collection_time" in r]
    return 1e3 * sum(t) / len(t) if t else None
