"""step_host_ms: the host's unblocked time in the port's dtc/env.step spans
(their host seconds less the seconds blocked in the syncs inside them;
deep_tracking_control_tpu_torch/utils/trace.py), per step, over the
unprofiled window calls' rows, in ms.  None where the rows carry no
"trace" (a program without the tracer)."""


def read(run):
    spans = [r["trace"]["spans"].get("dtc/env.step") for r in run.rows
             if "trace" in r]
    spans = [a for a in spans if a and a["count"]]
    if not spans:
        return None
    return 1e3 * (sum(a["host_s"] - a["wait_s"] for a in spans)
                  / sum(a["count"] for a in spans))
