"""Timing of the port's host side: the span recorder and the performance
monitor.

**The span recorder** (`RECORDER`; `span`, `begin`, `end`, `current`,
`enable`, `snapshot` are its methods). One process-global flight recorder
of named spans on the host clock `time.perf_counter_ns()`, the clock a
benchmark's window and a device trace's anchor are read on, so a reader
puts program spans on a trace's clock with one shift. Each closed span is
one record: name, start, end, the thread that opened it, its id, its
parent (the span current on that thread when it opened), a request id
(given, else the parent's, else a fresh one) and two integers of payload,
`n` and `m`. Records go into a preallocated ring of `CAPACITY` slots of
80 bytes in one `bytearray`; a slot is claimed with `next()` on a counter
and written by one `struct.pack_into`, each a single call that the
interpreter lock makes atomic, so no other lock is taken, no record is
torn and the ring never grows. It holds no Python objects, so full
collections do not walk it (a ring of lists of ints made each full
collection of the port's heap 75% slower on the CPU). A record that the
ring overwrites is counted in `dropped()`,
and `snapshot` says whether any record it lost reached into the window
asked for. Spans read the host clock only: none synchronises, reads or
allocates on the device.

While enabled (the default) a `gc.callbacks` hook counts every
generation's collections and records each full (generation-2) collection
as a `gc.full` span, `n` the objects it collected. Per-name totals since
start (count, nanoseconds) are kept per thread, each thread writing only
its own, and summed by `totals()` for `utils/metrics.make_span_source`.
`enable(False)` records nothing and removes the hook.

The spans the port records, and the metrics that read them, are listed in
PERF.md §3.

**PerformanceMonitor**: moving averages against explicit targets
(reference: crates/codegraph-core/src/performance_monitor.rs:10-622 —
PerformanceTargets with baseline->target pairs, :56-90: vector search
200->100 ms, node query 100->50 ms, 1k->2k QPS, 10k->20k nodes/s,
500->1000 embeddings/s); its `timer` also records a span.
"""

from __future__ import annotations

import gc
import itertools
import struct
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional

#: slots of the process-global ring: a 20 s window of the busiest
#: benchmark cell records ~38k spans
CAPACITY = 1 << 17

_now = time.perf_counter_ns
_ident = threading.get_ident
#: one record: write number + 1 (0: an empty slot), name code, start, end,
#: thread, id, parent, request id, n, m
_RECORD = struct.Struct("<10q")
_FIELDS = 10


class Span:
    """An open span. `n` and `m` may be set until it ends. As a context
    manager it is current on the entering thread (spans opened there nest
    under it) and ends on exit."""

    __slots__ = ("rec", "stack", "name", "code", "n", "m", "rid", "id", "parent", "thread", "t0")

    def __enter__(self) -> "Span":
        self.stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        self.rec.end(self)
        return False


class _Off:
    """What `span` and `begin` give while the recorder is off: payload
    writes land here and nothing is recorded."""

    __slots__ = ("n", "m", "rid", "id")

    def __init__(self):
        self.n = self.m = 0
        self.rid = self.id = -1

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Record(NamedTuple):
    name: str
    t0: int        # perf_counter_ns at open
    t1: int        # perf_counter_ns at close
    thread: int    # threading.get_ident() of the opening thread
    id: int
    parent: int    # -1: none
    rid: int
    n: int
    m: int


@dataclass
class Snapshot:
    records: List[Record]   # closed spans overlapping the window, by start
    dropped: int            # records overwritten since start, in all
    complete: bool          # no overwritten record reached into the window


class Recorder:
    """The span ring; see the module docstring. Starts disabled."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self._ring = bytearray(_RECORD.size * capacity)
        self._pack = _RECORD.pack_into
        self._names: List[str] = []
        self._codes: Dict[str, int] = {}
        self._names_lock = threading.Lock()
        self._written = itertools.count()
        self._ids = itertools.count()
        self._requests = itertools.count(1)
        self._lost_t1 = -1                   # latest end among overwritten records
        self._tls = threading.local()
        self._totals: Dict[int, Dict[str, list]] = {}
        self.on = False
        self.gc_collections = [0, 0, 0]
        self._gc_span: Optional[Span] = None

    # -- recording -----------------------------------------------------------

    def _stack(self) -> list:
        try:
            return self._tls.stack
        except AttributeError:
            self._tls.stack = []
            # a thread that reuses a finished thread's ident carries on its
            # totals: the two never write at once
            self._tls.totals = self._totals.setdefault(_ident(), {})
            return self._tls.stack

    def _code(self, name: str) -> int:
        with self._names_lock:  # once per name
            code = self._codes.get(name)
            if code is None:
                code = self._codes[name] = len(self._names)
                self._names.append(name)
            return code

    def new_request(self) -> int:
        """A fresh request id."""
        return next(self._requests)

    def begin(self, name: str, n: int = 0, m: int = 0, rid: Optional[int] = None):
        """Open a span that any thread may `end`; it is not made current.
        `with span(...) as s:` (the same method) makes it current on this
        thread for the block and ends it there."""
        if not self.on:
            return OFF
        try:
            stack = self._tls.stack
        except AttributeError:
            stack = self._stack()
        s = Span()
        code = self._codes.get(name)
        s.code = self._code(name) if code is None else code
        if stack:
            top = stack[-1]
            s.parent = top.id
            s.rid = top.rid if rid is None else rid
        else:
            s.parent = -1
            s.rid = next(self._requests) if rid is None else rid
        s.rec, s.stack, s.name, s.n, s.m = self, stack, name, n, m
        s.id = next(self._ids)
        s.thread = _ident()
        s.t0 = _now()
        return s

    span = begin

    def end(self, s, n: Optional[int] = None, m: Optional[int] = None) -> None:
        """Close `s` (from any thread) and write its record."""
        t1 = _now()
        if s is OFF:
            return
        if n is not None:
            s.n = n
        if m is not None:
            s.m = m
        seq = next(self._written)
        at = (seq & self._mask) * _RECORD.size
        if seq >= self.capacity:
            lost = _RECORD.unpack_from(self._ring, at)[3]
            if lost > self._lost_t1:
                # benign race: two writers overwriting at once may keep the
                # earlier of their lost ends, a few microseconds early
                self._lost_t1 = lost
        self._pack(self._ring, at, seq + 1, s.code, s.t0, t1, s.thread, s.id, s.parent, s.rid,
                   s.n, s.m)
        try:
            totals = self._tls.totals
        except AttributeError:
            self._stack()
            totals = self._tls.totals
        c = totals.get(s.name)
        if c is None:
            c = totals[s.name] = [0, 0]
        c[0] += 1
        c[1] += t1 - s.t0

    @contextmanager
    def current(self, s) -> Iterator[None]:
        """Make the open span `s` (opened by `begin`, perhaps on another
        thread) current on this thread for the block; it does not end it."""
        if s is OFF:
            yield
            return
        stack = self._stack()
        stack.append(s)
        try:
            yield
        finally:
            if stack and stack[-1] is s:
                stack.pop()

    # -- switching and the collector hook -------------------------------------

    def enable(self, flag: bool = True) -> None:
        """Record (True) or not (False); the gc hook is installed only while on."""
        self.on = bool(flag)
        hooked = self._on_gc in gc.callbacks
        if self.on and not hooked:
            gc.callbacks.append(self._on_gc)
        elif not self.on and hooked:
            gc.callbacks.remove(self._on_gc)
            self._gc_span = None

    def _on_gc(self, phase: str, info: dict) -> None:
        # collections do not nest and callbacks run one at a time
        gen = info["generation"]
        if phase == "start":
            if gen == 2:
                self._gc_span = self.begin("gc.full")
            return
        self.gc_collections[gen] += 1
        s, self._gc_span = self._gc_span, None
        if gen == 2 and s is not None:
            self.end(s, n=info.get("collected", 0))

    # -- reading ---------------------------------------------------------------

    def _columns(self) -> List[list]:
        """The ring's fields, one list each, from one copy of the ring."""
        flat = memoryview(bytes(self._ring)).cast("q")
        return [flat[f::_FIELDS].tolist() for f in range(_FIELDS)]

    def dropped(self) -> int:
        """Records overwritten since start: the highest write number in
        the ring less the ring's slots."""
        return self._dropped(memoryview(bytes(self._ring)).cast("q")[0::_FIELDS].tolist())

    def _dropped(self, written: list) -> int:
        return max(0, max(written) - self.capacity)

    def snapshot(self, t0_ns: int, t1_ns: int) -> Snapshot:
        """The closed spans that overlap [t0_ns, t1_ns], by start."""
        cols = self._columns()
        # read after the copy: a writer raises it before overwriting a slot
        lost_t1 = self._lost_t1
        written, codes, starts, ends = cols[:4]
        names = list(self._names)
        records = [Record(names[codes[i]], *(c[i] for c in cols[2:]))
                   for i, w in enumerate(written)
                   if w and starts[i] <= t1_ns and ends[i] >= t0_ns]
        records.sort(key=lambda r: r.t0)
        return Snapshot(records=records, dropped=self._dropped(written),
                        complete=lost_t1 < t0_ns)

    def totals(self) -> Dict[str, tuple]:
        """{span name: (count, seconds)} over every span closed since start."""
        out: Dict[str, list] = {}
        for per_thread in list(self._totals.values()):
            for name, (count, ns) in list(per_thread.items()):
                acc = out.setdefault(name, [0, 0])
                acc[0] += count
                acc[1] += ns
        return {name: (count, ns * 1e-9) for name, (count, ns) in out.items()}


RECORDER = Recorder()
RECORDER.enable(True)
span = RECORDER.span
begin = RECORDER.begin
end = RECORDER.end
current = RECORDER.current
enable = RECORDER.enable
snapshot = RECORDER.snapshot
new_request = RECORDER.new_request


@dataclass(frozen=True)
class Target:
    baseline: float
    target: float
    unit: str
    lower_is_better: bool = True


@dataclass(frozen=True)
class PerformanceTargets:
    """Baseline -> target pairs (performance_monitor.rs:56-90)."""

    vector_search_ms: Target = Target(200.0, 100.0, "ms")
    node_query_ms: Target = Target(100.0, 50.0, "ms")
    edge_traversal_ms: Target = Target(50.0, 25.0, "ms")
    rag_latency_ms: Target = Target(200.0, 100.0, "ms")
    query_qps: Target = Target(1000.0, 2000.0, "qps", lower_is_better=False)
    nodes_per_second: Target = Target(10_000.0, 20_000.0, "nodes/s", lower_is_better=False)
    embeddings_per_second: Target = Target(500.0, 1000.0, "emb/s", lower_is_better=False)


@dataclass
class MetricWindow:
    window: int = 100
    values: deque = field(default_factory=lambda: deque(maxlen=100))

    def record(self, v: float) -> None:
        self.values.append(v)

    @property
    def mean(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0

    @property
    def p95(self) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        return s[min(len(s) - 1, int(0.95 * len(s)))]


class PerformanceMonitor:
    def __init__(self, targets: Optional[PerformanceTargets] = None):
        self.targets = targets or PerformanceTargets()
        self.metrics: Dict[str, MetricWindow] = {}

    def record(self, name: str, value: float) -> None:
        self.metrics.setdefault(name, MetricWindow()).record(value)

    @contextmanager
    def timer(self, name: str, span_name: Optional[str] = None) -> Iterator[None]:
        """Record the block's elapsed ms under `name`, and the block as a
        span of the recorder named `span_name` (default: `name`)."""
        with RECORDER.span(span_name or name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.record(name, (time.perf_counter() - t0) * 1000.0)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, win in self.metrics.items():
            entry = {"mean": round(win.mean, 3), "p95": round(win.p95, 3),
                     "n": len(win.values)}
            target = getattr(self.targets, name, None)
            if isinstance(target, Target):
                entry["baseline"] = target.baseline
                entry["target"] = target.target
                meets = (
                    win.mean <= target.target if target.lower_is_better
                    else win.mean >= target.target
                )
                entry["meets_target"] = bool(meets)
            out[name] = entry
        return out


__all__ = ["CAPACITY", "MetricWindow", "OFF", "PerformanceMonitor", "PerformanceTargets",
           "RECORDER", "Record", "Recorder", "Snapshot", "Span", "Target", "begin", "current",
           "enable", "end", "new_request", "snapshot", "span"]
