"""Spans and counters inside the port: the host's time in each layer, its
blocking host-device syncs and the kernels it launched, per learn
iteration.

    from ..utils import trace

    with trace.span("dtc/learn/stats"):           # a layer's boundary
        ...
        with trace.sync("dtc/sync/stats"):        # a blocking point
            vec = vec.cpu()

    @trace.spanned("dtc/act")                      # a whole function
    def act(...): ...

A span reads the host clock (time.perf_counter_ns) as it opens and as it
closes, and adds to its name's aggregates: count, host_ns (open to close)
and wait_ns, the host's time blocked in sync spans anywhere inside it (a
sync span's own wait is its whole duration).  host - wait is the host's
unblocked time in the span.  A sync span also counts one of the
iteration's `syncs` (implicit: a pageable host-to-device copy or a
device-to-host read, which torch completes with a stream synchronize)
or `explicit_syncs` (torch.cuda.synchronize).  Spans nest as the with
statements do: a span's wait is what the process's total of sync time
grew by while it was open, so a sync's time counts in every span around
it.  A span of one name does not open inside another of the same name,
and a name is either a span or a sync.

runner/train.py `learn` brackets each iteration with begin(it) and end();
end() returns what its row holds under "trace": the iteration number,
per span name count, host_s and wait_s, syncs, explicit_syncs, the
launches of each kernel wrapper (K1-K9) in the iteration, the deltas of
their `.launches` counters, and per CUDA graph name (env/step_graph.py:
"env.step") its calls in the iteration by kind, "captures", "replays" and
"eager" (`graph_call`).  A replay runs no wrapper, so it adds the
launches its capture counted to the counters (`add_launches`).  Only
aggregates are kept, never an event, and a span touches no tensor: it
launches nothing, syncs nothing and allocates no device memory.

While torch.profiler records, a span also opens
torch.profiler.record_function(name), so the program's spans are
`user_annotation` ranges of the profiler's trace, on the clock of the
device's operations.

The tracer is one per process and not thread-safe: the runner's thread
drives it.  `enabled = False` makes every span a shared no-op and end()
return None; set it between iterations.
"""
from __future__ import annotations

import contextlib
import functools
from time import perf_counter_ns

from torch.autograd import profiler as _profiler

enabled = True

_SPAN, _SYNC, _EXPLICIT = 0, 1, 2

_wait_ns = 0                  # the process's sync time so far
_spans: dict = {}             # name -> _Span, with its aggregates
_syncs = [0, 0, 0]            # closed spans of each kind (syncs: 1 and 2)
_iteration = None             # the open iteration's number
_launches0: dict = {}         # the launch counters at begin()
GRAPH_CALLS = ("captures", "replays", "eager")
_graphs: dict = {}            # graph name -> {kind: calls this iteration}


class _Span:
    """One name's aggregates, and its open interval: the clock and the
    process's sync time as it opened."""
    __slots__ = ("name", "kind", "count", "host_ns", "wait_ns", "t0", "w0")

    def __init__(self, name: str, kind: int):
        self.name, self.kind = name, kind
        self.count = self.host_ns = self.wait_ns = 0

    def __enter__(self):
        self.w0 = _wait_ns
        self.t0 = perf_counter_ns()

    def __exit__(self, exc_type, exc, tb):
        global _wait_ns
        dt = perf_counter_ns() - self.t0
        if self.kind:
            _wait_ns += dt
            _syncs[self.kind] += 1
        self.count += 1
        self.host_ns += dt
        self.wait_ns += _wait_ns - self.w0


class _Recorded:
    """A span inside a record_function range of the same name (while the
    profiler records); the span's clock excludes the range's own cost."""
    __slots__ = ("span", "rf")

    def __init__(self, s: _Span):
        self.span = s
        self.rf = _profiler.record_function(s.name)

    def __enter__(self):
        self.rf.__enter__()
        self.span.__enter__()

    def __exit__(self, exc_type, exc, tb):
        self.span.__exit__(exc_type, exc, tb)
        self.rf.__exit__(exc_type, exc, tb)


_OFF = contextlib.nullcontext()


def _new(name: str, kind: int) -> _Span:
    s = _spans[name] = _Span(name, kind)
    return s


def span(name: str):
    """A context manager: the host's time in `name`."""
    if not enabled:
        return _OFF
    s = _spans.get(name) or _new(name, _SPAN)
    return _Recorded(s) if _profiler._is_profiler_enabled else s


def sync(name: str, explicit: bool = False):
    """A context manager around one blocking host-device sync: an implicit
    one (a blocking copy) or, explicit=True, torch.cuda.synchronize."""
    if not enabled:
        return _OFF
    s = _spans.get(name) or _new(name, _EXPLICIT if explicit else _SYNC)
    return _Recorded(s) if _profiler._is_profiler_enabled else s


def spanned(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


_COUNTERS = None


def _counters() -> tuple:
    """(kernel, holder, attribute) of each kernel wrapper's launch counter,
    through their modules' fixed references (a caller may wrap the public
    functions)."""
    global _COUNTERS
    if _COUNTERS is None:
        _COUNTERS = _find_counters()
    return _COUNTERS


def _find_counters() -> tuple:
    from ..env import cuda_obs, cuda_planner, cuda_rewards
    from ..ops import cuda_gather, cuda_patch, cuda_rng
    from ..physics import cuda_substep
    from ..terrain import cuda_sampler
    k1 = cuda_substep._counter
    return (("K1", k1, "launches"), ("K1w", k1, "window_launches"),
            ("K1f64", k1, "f64_launches"),
            ("K2", cuda_sampler._counter, "launches"),
            ("K3", cuda_planner._counter, "launches"),
            ("K4", cuda_patch._patches, "launches"),
            ("K5", cuda_patch._windows, "launches"),
            ("K6", cuda_rewards._counter, "launches"),
            ("K7", cuda_obs._counter, "launches"),
            ("K8", cuda_rng._counter, "launches"),
            ("K9", cuda_gather._counter, "launches"))


def launches() -> dict:
    """The kernel wrappers' launch counters."""
    return {k: getattr(o, a) for k, o, a in _counters()}


def add_launches(counts: dict):
    """Add `counts` {kernel: launches} to the wrappers' counters: what a
    CUDA graph's replay launched, which its capture counted.  Counts
    whether or not tracing is on, as the wrappers do."""
    for k, o, a in _counters():
        if counts.get(k):
            setattr(o, a, getattr(o, a) + counts[k])


def graph_call(name: str, kind: str):
    """Count one call of CUDA graph `name` (env/step_graph.py) of `kind`, a
    GRAPH_CALLS entry: a capture, a replay, or an eager run of the body.
    A no-op while tracing is off."""
    if enabled:
        calls = _graphs.get(name)
        if calls is None:
            calls = _graphs[name] = dict.fromkeys(GRAPH_CALLS, 0)
        calls[kind] += 1


def begin(iteration: int):
    """Open iteration `iteration`: zero the aggregates and read the launch
    counters.  A no-op while tracing is off."""
    global _iteration, _launches0
    _iteration = None
    if not enabled:
        return
    for s in _spans.values():
        s.count = s.host_ns = s.wait_ns = 0
    _syncs[:] = [0, 0, 0]
    for calls in _graphs.values():
        calls.update(dict.fromkeys(GRAPH_CALLS, 0))
    _launches0 = launches()
    _iteration = iteration


def end():
    """Close the open iteration: its aggregates (the row's "trace"), or
    None without an open iteration or while tracing is off."""
    global _iteration
    if not enabled or _iteration is None:
        return None
    spans = {s.name: dict(count=s.count, host_s=s.host_ns * 1e-9,
                          wait_s=s.wait_ns * 1e-9)
             for s in _spans.values() if s.count}
    out = dict(iteration=_iteration, spans=spans, syncs=_syncs[_SYNC],
               explicit_syncs=_syncs[_EXPLICIT],
               launches={k: v - _launches0[k]
                         for k, v in launches().items()},
               graphs={k: dict(v) for k, v in _graphs.items()})
    _iteration = None
    return out
