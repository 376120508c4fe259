"""Reading a torch.profiler trace: device operations, the host ranges that
launched them, busy and idle time.

The input is the list of events of a Chrome trace as
`torch.profiler.profile.export_chrome_trace` writes it (complete events,
"ph": "X", times in microseconds):
  * device operations: "cat" "kernel", "gpu_memcpy" or "gpu_memset", each
    with args.correlation;
  * launches: "cat" "cuda_runtime" or "cuda_driver" events with the same
    args.correlation, on the host thread that made them;
  * the benchmark's ranges: "cat" "user_annotation" events named by
    `torch.profiler.record_function` in harness/program.py.
A device operation belongs to the innermost range of each name whose host
interval holds its launch.  Host and device times share one clock in
Kineto's export.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"


@dataclass
class DeviceOp:
    name: str
    start: float          # us
    dur: float            # us
    ranges: tuple = ()    # names of the benchmark ranges around the launch


@dataclass
class Trace:
    ops: list = field(default_factory=list)          # DeviceOp, by start
    ranges: dict = field(default_factory=dict)       # name -> [(start, end)]

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        launches = {}
        ranges = {}
        dev = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = float(e["ts"])
            elif cat == RANGE_CAT:
                ranges.setdefault(e["name"], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
        for v in ranges.values():
            v.sort()
        ops = []
        for e in dev:
            corr = (e.get("args") or {}).get("correlation")
            t = launches.get(corr)
            names = tuple(n for n, iv in ranges.items()
                          if t is not None and _inside(iv, t))
            ops.append(DeviceOp(e["name"], float(e["ts"]),
                                float(e.get("dur", 0)), names))
        ops.sort(key=lambda o: o.start)
        return cls(ops, ranges)

    # ---------------- windows ----------------
    def span(self, name: str):
        """(first start, last end) of the ranges called `name`, or None."""
        iv = self.ranges.get(name)
        if not iv:
            return None
        return iv[0][0], max(end for _, end in iv)

    def count(self, name: str) -> int:
        return len(self.ranges.get(name, ()))

    def in_range(self, name: str) -> list:
        return [o for o in self.ops if name in o.ranges]

    def device_s(self, name: str) -> float:
        """Seconds of device operations launched inside ranges `name`."""
        return sum(o.dur for o in self.in_range(name)) * 1e-6

    def busy_s(self, start: float, end: float) -> float:
        """Seconds in [start, end] (us) in which some device operation ran:
        the union of their intervals, clipped to the window."""
        total, cur_s, cur_e = 0.0, None, None
        for o in self.ops:
            s, e = max(o.start, start), min(o.start + o.dur, end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def gaps(self, start: float, end: float) -> list:
        """[(gap start, gap length)] in us: the device's idle intervals in
        [start, end]."""
        out, t = [], start
        for o in self.ops:
            s, e = max(o.start, start), min(o.start + o.dur, end)
            if e <= s:
                continue
            if s > t:
                out.append((t, s - t))
            t = max(t, e)
        if end > t:
            out.append((t, end - t))
        return out

    def host_label(self, t: float, order: tuple) -> str:
        """The benchmark ranges (in `order`, outermost first) that the host
        was inside at time t, joined by '>', or 'outside'."""
        names = [n for n in order if _inside(self.ranges.get(n, ()), t)]
        return ">".join(names) if names else "outside"

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, start: float, end: float, order: tuple,
                     n: int = 10) -> list:
        """[[host ranges, seconds]] of device idle time in [start, end],
        summed by where the host was when each gap began, largest first."""
        by = {}
        for s, d in self.gaps(start, end):
            k = self.host_label(s, order)
            by[k] = by.get(k, 0.0) + d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _inside(intervals, t: float) -> bool:
    """Whether t lies in one of the sorted, disjoint intervals."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][1] >= t


def is_kernel(op_name: str, symbol: str) -> bool:
    """Whether a profiler kernel name is the CUDA kernel `symbol` (the
    port's kernels lie in an anonymous namespace and may be templates)."""
    for sep in ("<", "("):
        if f"::{symbol}{sep}" in op_name or op_name.startswith(symbol + sep):
            return True
    return op_name == symbol or op_name.endswith("::" + symbol)
