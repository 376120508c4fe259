"""step_device_ops: device operations (kernels, copies, fills) launched
inside the env.step ranges of the traced calls, per step."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("env.step") or not tr.in_range("env.step"):
        return None
    return len(tr.in_range("env.step")) / tr.count("env.step")
