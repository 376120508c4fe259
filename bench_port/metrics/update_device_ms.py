"""update_device_ms: device time of the operations launched inside the
update ranges (PPO.update: the gather K9, the minibatch steps, Adam) of
the traced calls, per update, in ms."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("update") or not tr.in_range("update"):
        return None
    return 1e3 * tr.device_s("update") / tr.count("update")
