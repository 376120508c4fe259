"""act_host_ms: the host's unblocked time in the port's dtc/act spans
(PPO.act, and the critic of the collect's last values), per act, over
the unprofiled window calls' rows, in ms.  None where the rows carry no
"trace"."""


def read(run):
    spans = [r["trace"]["spans"].get("dtc/act") for r in run.rows
             if "trace" in r]
    spans = [a for a in spans if a and a["count"]]
    if not spans:
        return None
    return 1e3 * (sum(a["host_s"] - a["wait_s"] for a in spans)
                  / sum(a["count"] for a in spans))
