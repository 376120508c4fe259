"""act_device_ms: device time of the operations launched inside the act
ranges (PPO.act: the CE-net, terrain encoder, actor and critic forward
and the action draw) of the traced calls, per act, in ms."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("act") or not tr.in_range("act"):
        return None
    return 1e3 * tr.device_s("act") / tr.count("act")
