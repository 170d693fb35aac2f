"""Spans and counters of the port: which phase of a call the host spent its
time in, and, under `torch.profiler`, which phase launched each device
operation.

    with spans.span("env.observe"):
        obs = envx.observe_hamt(...)
    spans.count("rollout.steps")
    if spans.host_read(st.ended.all()):
        break

Spans are off by default.  `span` then returns one shared null context and
records nothing, so a span left in the code costs a function call.
A `with on():` block turns them on: each span is then
kept in memory as a `Record` (its name, the span it opened under, start and
end on `time.perf_counter_ns()`, the call it belongs to and the rollout
step) until `take()` hands the records out.  A span opened under no other
is a root (`eval.call`, `train.step`, a `setup.*` part) and starts a new
call id.  While a `torch.profiler` is active too, each span is also a
`record_function` annotation: it lies on the profiler's timeline, where
each device operation leads by its correlation id to the runtime call that
launched it, and so to the innermost span open at that moment.

Counters are always on: `count(name, n)`, `counts()`, `reset_counts()`.
A step that DUET's greedy eval replays as a captured CUDA graph counts on
the host what its capture counted (`held_counts`, `add_counts`), and the
counters `rollout.graph_captures` and `rollout.graph_replays` count the
captures and the replays: replays over `rollout.steps` is the share of
steps the graph served.
`host_read(x)` is the one way the rollouts read a device value on the
host: it counts `host_reads`, runs in a `rollout.host_read` span, and is the
one place that lifts `torch.cuda.set_sync_debug_mode`, so that a test can
turn every other host synchronisation of a call into an error.

The state is the process's, like the profiler's: one thread opens spans.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import Counter
from typing import NamedTuple

import torch


class Record(NamedTuple):
    id: int
    name: str
    parent: int | None    # the id of the span it opened under
    call: int             # the number of its root span
    step: int | None      # the rollout step, inherited from the parent
    start_ns: int
    end_ns: int


_NULL = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.on = False
        self.records: list[Record] = []
        self.open: list[_Span] = []
        self.counts: Counter = Counter()
        self.ids = 0
        self.calls = 0


_state = _State()


class _Span:
    __slots__ = ("name", "step", "id", "parent", "call", "start", "annotation")

    def __init__(self, name: str, step: int | None):
        self.name, self.step = name, step

    def __enter__(self):
        st = _state
        parent = st.open[-1] if st.open else None
        self.id = st.ids
        st.ids += 1
        if parent is None:
            self.parent, self.call = None, st.calls
            st.calls += 1
        else:
            self.parent, self.call = parent.id, parent.call
            if self.step is None:
                self.step = parent.step
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.autograd.profiler.record_function(self.name)
            self.annotation.__enter__()
        st.open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _state.open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _state.records.append(Record(self.id, self.name, self.parent,
                                     self.call, self.step, self.start, end))
        return False


def span(name: str, step: int | None = None):
    """A context manager around one phase; the shared null context when
    spans are off."""
    return _Span(name, step) if _state.on else _NULL


def spanned(name: str):
    """Decorator: every call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enabled() -> bool:
    """Whether spans are on."""
    return _state.on


@contextlib.contextmanager
def on():
    """Spans on inside the block, as they were after it."""
    was = _state.on
    _state.on = True
    try:
        yield
    finally:
        _state.on = was


def take() -> list[Record]:
    """The records of the spans closed since the last `take`, by start."""
    out = sorted(_state.records, key=lambda r: (r.start_ns, r.id))
    _state.records.clear()
    return out


def self_ns(records: list[Record]) -> dict[int, int]:
    """Each span's self time: its duration less the part of it that its
    child spans cover."""
    children: dict[int, list] = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = {}
    for r in records:
        covered, end = 0, r.start_ns
        for s, e in sorted(children.get(r.id, ())):
            s, e = max(s, end), min(e, r.end_ns)
            if e > s:
                covered += e - s
                end = e
        out[r.id] = r.end_ns - r.start_ns - covered
    return out


def count(name: str, n: int = 1) -> None:
    _state.counts[name] += n


def counts() -> dict[str, int]:
    return dict(_state.counts)


@contextlib.contextmanager
def held_counts():
    """Counts made inside the block go to the Counter it yields, not to the
    process's: what a captured CUDA graph's step counted on the host, which
    each replay of it then adds (`add_counts`)."""
    held, saved = Counter(), _state.counts
    _state.counts = held
    try:
        yield held
    finally:
        _state.counts = saved


def add_counts(counts) -> None:
    """Add a Counter (`held_counts`) to the process's counters."""
    _state.counts.update(counts)


def reset_counts(prefix: str = "") -> None:
    """Clear the counters whose names start with `prefix` (all by default)."""
    for name in [k for k in _state.counts if k.startswith(prefix)]:
        del _state.counts[name]


def host_read(x: torch.Tensor) -> bool:
    """`bool(x)`: a counted host read of a device value, the one place a
    synchronisation is allowed under `torch.cuda.set_sync_debug_mode`."""
    _state.counts["host_reads"] += 1
    mode = torch.cuda.get_sync_debug_mode() if x.is_cuda else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        with span("rollout.host_read"):
            return bool(x)
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
