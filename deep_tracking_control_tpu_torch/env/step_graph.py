"""The env step as one CUDA graph: `LeggedEnv.step`'s body captured once
and replayed on every later step, so that the host issues one graph
launch in place of the step's ~350 device ops.

A `StepGraph` belongs to one (env, params, generator).  Its first call
runs the body eagerly (the warm-up: kernel builds, lazy tables, the
allocator); its second captures the body with the generator registered,
so that a replay draws the Philox offsets the eager step would, and
replays it; every later call copies its inputs into the graph's static
buffers and replays.  A replay runs the body's kernels in its order on
the same values, so its outputs equal the eager step's bit for bit.

The static buffers: the params' own tensors (the graph reads them where
they lie), clones of the capture's state and actions.  A caller's tensor
is copied in (one `torch._foreach_copy_`) unless it lies where its buffer
does, as a state field that the step passes through unchanged does.  The
state a replay returns is the graph's own outputs, copied in by the next
call.  So the tensors a call returns stay valid only until the next call
of the same graph: a caller copies what it keeps past it
(runner/train.py `collect`).  A call whose inputs differ in layout (keys,
shapes, dtypes, or a non-tensor leaf such as the terrain) from the
capture's runs eagerly.

The tracer (utils/trace.py) counts each call as "eager", a "captures" or
a "replays" of "env.step", and a replay adds the kernel launches its
capture counted to the wrappers' counters.
"""
from __future__ import annotations

import operator

import torch

from ..utils import trace

NAME = "env.step"


def _flatten(tree, leaves: list, keys: list):
    """Append the leaves of nested dicts and tuples to `leaves` and each
    dict's keys to `keys`, in order."""
    if isinstance(tree, dict):
        keys.append(tuple(tree))
        tree = tree.values()
    for v in tree:
        if isinstance(v, (dict, tuple)):
            _flatten(v, leaves, keys)
        else:
            leaves.append(v)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree


def _fresh(tree):
    """New containers around the same leaves: a caller may add to or
    replace the fields of what it was returned."""
    if isinstance(tree, tuple):
        return tuple(_fresh(v) for v in tree)
    return {k: _fresh(v) if type(v) is dict else v for k, v in tree.items()}


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class StepGraph:
    """The captured step of one (env, params, generator)."""

    def __init__(self, params, generator):
        # held, so that the ids keying this graph stay theirs
        self.params, self.generator = params, generator
        self.warm = False
        self.graph = None

    def __call__(self, body, params, state, actions):
        """body(params, state, actions, generator) -> (state, out), run
        eagerly, captured or replayed."""
        if self.graph is None and not self.warm:
            self.warm = True
            trace.graph_call(NAME, "eager")
            return body(params, state, actions, self.generator)
        if self.graph is None:
            return self._capture(body, params, state, actions)
        copies = self._copies(params, state)
        if copies is None or not _same(actions, self.actions):
            trace.graph_call(NAME, "eager")
            return body(params, state, actions, self.generator)
        for dst, src in copies:
            torch._foreach_copy_(dst, src)
        self.actions.copy_(actions)
        self.graph.replay()
        trace.add_launches(self.launches)
        trace.graph_call(NAME, "replays")
        return _fresh(self.outputs)

    def _copies(self, params, state):
        """[(static buffers, caller's tensors)] of one dtype each to copy
        in, or None where the inputs' layout is not the capture's.  The
        caller's state is most often the last replay's: its copies are
        planned at the capture."""
        leaves, keys = [], []
        _flatten((params, state), leaves, keys)
        if keys != self.keys or len(leaves) != len(self.static):
            return None
        if self.plan is not None and all(
                map(operator.is_, leaves, self.returned)):
            return self.plan
        pairs = []
        for s, v in zip(self.static, leaves):
            if v is s:
                continue
            if not _same(v, s):
                return None
            if v.data_ptr() != s.data_ptr():
                pairs.append((s, v))
        return _by_dtype(pairs)

    def _capture(self, body, params, state, actions):
        static_state = _clone(state)
        self.actions = actions.clone()
        self.static, self.keys = [], []
        _flatten((params, static_state), self.static, self.keys)
        buffers = {_storage(t) for t in self.static + [self.actions]
                   if isinstance(t, torch.Tensor)}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = trace.launches()
        with torch.cuda.graph(graph):
            new_state, out = body(params, static_state, self.actions,
                                  self.generator)
            new_state = _own(new_state, static_state, buffers)
        self.launches = {k: v - before[k]
                         for k, v in trace.launches().items()}
        self.outputs = (new_state, out)
        # the copies of a call that passes the returned state back
        self.returned, keys = [], []
        _flatten((params, new_state), self.returned, keys)
        pairs = [(s, v) for s, v in zip(self.static, self.returned)
                 if v is not s]
        self.plan = (_by_dtype(pairs) if keys == self.keys
                     and all(_same(v, s) for s, v in pairs) else None)
        self.graph = graph
        graph.replay()
        trace.graph_call(NAME, "captures")
        return _fresh(self.outputs)


def _same(v, s) -> bool:
    """Whether v is a tensor of static buffer s's shape, dtype and
    device."""
    return (isinstance(v, torch.Tensor) and isinstance(s, torch.Tensor)
            and v.shape == s.shape and v.dtype == s.dtype
            and v.device == s.device)


def _by_dtype(pairs) -> list:
    """[(buffers, sources)] to copy with one `_foreach_copy_` each: a list
    of one dtype whose tensors are dense and laid out as their buffers
    takes its fast path (a few kernels for the whole list); the rest go
    apart."""
    groups = {}
    for s, v in pairs:
        fast = _dense(s) and _dense(v) and s.stride() == v.stride()
        dst, src = groups.setdefault((s.dtype, fast), ([], []))
        dst.append(s)
        src.append(v)
    return list(groups.values())


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill its storage span without gaps or
    overlap: some order of its dims is contiguous."""
    step = 1
    for size, stride in sorted(zip(t.shape, t.stride()),
                               key=lambda d: d[1]):
        if size == 1:
            continue
        if stride != step:
            return False
        step *= size
    return True


def _own(tree, static, buffers: set):
    """The returned state with a copy in place of each field that lies in
    a static buffer other than its own field's (the next call's copy-in
    would overwrite it before reading it); a field passed through
    unchanged is its own buffer and stays."""
    if isinstance(tree, dict):
        static = static if isinstance(static, dict) else {}
        return {k: _own(v, static.get(k), buffers) for k, v in tree.items()}
    if (isinstance(tree, torch.Tensor) and tree is not static
            and _storage(tree) in buffers):
        return tree.clone()
    return tree
