"""step_device_ms: device time of the operations launched inside the
env.step ranges of the traced calls, per step, in ms."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("env.step") or not tr.in_range("env.step"):
        return None
    return 1e3 * tr.device_s("env.step") / tr.count("env.step")
