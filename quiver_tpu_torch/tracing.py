"""Span tracing: a lock-cheap ring buffer and a Chrome/Perfetto export
(the port's own copy of ``quiver_tpu/tracing.py``; stdlib only).

This is the port's one span path. The program opens a span at each
layer boundary of its hot paths (``sampler.sample``, ``sample.draw``,
``sample.compact``, ``feature.lookup``, ``train.step``, ``serve.run``
and their children), the staging pipeline and the request path file
spans from timestamps they already hold (``pipeline.execute``,
``serve.dispatch``), and ``profiling.scope`` is a span too.

1. **Two switches.** Spans record while tracing is enabled
   (``QT_TRACE=1``, ``QT_TRACE=/path/out.json`` or :func:`enable`),
   and also while a ``torch.profiler`` session records on the calling
   thread, so a profiled block collects the program's spans with no
   call to :func:`enable`. Off, a span costs one attribute check and
   one profiler probe, and ``span`` hands out a shared no-op context
   manager.
2. **Lock-cheap when on.** Records land in a fixed-capacity ring: one
   ``next(itertools.count())`` for the slot and one list store for the
   record. When the ring wraps, the oldest spans are overwritten.
3. **No device synchronisation.** Nothing here reads a tensor on the
   hot path. ``profiling`` installs the torch side as a hook
   (:func:`install_hook`): under a profiler each span is also a
   ``RecordFunction`` range, and on a CUDA card each span records a
   pair of pooled timing events on the current stream. A span's
   counters (``Span.count``) may be device scalars, which the torch side
   copies out without waiting. :func:`resolve` reads events and
   counters back once the caller has synchronised:
   the events give the span's device extent, from the stream reaching
   its entry to the stream reaching its exit, idle inside included.
4. **One clock.** Records hold ``time.perf_counter()`` seconds. The
   exports write ``ts`` on the profiler's clock, as Kineto does: Unix
   microseconds less a base, the base written as
   ``baseTimeNanoseconds``. The ``perf_counter``-to-Unix offset is
   taken once, at :func:`enable` or at the first export.
   :func:`merge_chrome_traces` rebases files onto one base, so a ring
   export and a ``torch.profiler`` trace of the same run line up.

A record is ``(name, tid, t0, dur, trace_id, args, span, parent,
mark)``: ``t0`` and ``dur`` in ``perf_counter`` seconds, ``tid`` the
recording thread, ``trace_id`` an optional correlation id, ``args`` a
small JSON-able dict, ``span`` the span's id (None for a record filed
from timestamps), ``parent`` the id of the span open on the thread when
it began (None at the root), ``mark`` None or the :class:`Mark` of its
device events and counters. :func:`span_table` folds records into a
table by name (host ms, self ms, device ms, counters).
:func:`inject` and :func:`extract` carry a trace context across
processes in request metadata.

Usage::

    from quiver_tpu_torch import tracing
    tracing.enable()
    with tracing.span("stage.load", args={"rows": 4096}):
        ...
    tracing.export_chrome_trace("trace.json")
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from typing import (Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

Record = Tuple[str, int, float, float, Optional[int], Optional[dict],
               Optional[int], Optional[int], Optional["Mark"]]

DEFAULT_CAPACITY = 65536

# the compact carrier keys inject()/extract() use inside request
# metadata — namespaced so they coexist with application fields
CTX_TRACE_ID = "qt.trace_id"
CTX_PARENT = "qt.parent"
CTX_REPLICA = "qt.replica"


class TraceContext(NamedTuple):
    """The propagated trace context: the correlation id a client
    minted, the span name it was under (informational), and the
    SENDER's replica label."""

    trace_id: int
    parent: Optional[str] = None
    replica: Optional[str] = None


# the process's replica label (fleet identity): QT_REPLICA env, or
# set_replica(); stamps outgoing contexts and the Perfetto export's
# process_name row
_replica: Optional[str] = os.environ.get("QT_REPLICA") or None


def set_replica(name: Optional[str]) -> None:
    """Set this process's replica label (overrides ``QT_REPLICA``)."""
    global _replica
    _replica = str(name) if name else None


def get_replica() -> Optional[str]:
    return _replica


# -- the torch side, installed by ``profiling`` -------------------------------


def _never() -> bool:
    return False


class _Hook(NamedTuple):
    """What ``profiling`` installs: ``probe()`` is true while a
    ``torch.profiler`` session records on the calling thread;
    ``enter(name)`` opens the span's torch side and returns a token;
    ``exit(token)`` closes it and returns the span's device events, an
    object whose ``elapsed()`` gives their milliseconds (None once the
    pool has reused them), or None; ``stage(counts)`` moves a span's
    tensor counters out of the record without waiting for the device and
    returns what :class:`Mark` reads them from (an object whose
    ``read()`` gives a dict of ints, None once reused)."""

    probe: Callable[[], bool]
    enter: Callable[[str], object]
    exit: Callable[[object], Optional[object]]
    stage: Callable[[dict], object]


_hook: Optional[_Hook] = None
_probe: Callable[[], bool] = _never


def install_hook(hook: Optional[_Hook]) -> None:
    """Install (or, with None, remove) the torch side of the spans."""
    global _hook, _probe
    _hook = hook
    _probe = hook.probe if hook is not None else _never


class Mark:
    """What a span leaves to read after the caller has synchronised:
    its device events and its counters (numbers, or what the torch side
    staged them into). :meth:`resolve` reads them once and keeps
    ``device_ms`` (None without events) and ``values`` (ints, passed
    through the span's ``derive`` function if it has one)."""

    __slots__ = ("events", "counts", "derive", "device_ms", "values")

    def __init__(self, events, counts, derive=None):
        self.events = events
        self.counts = counts
        self.derive = derive
        self.device_ms: Optional[float] = None
        self.values: Optional[Dict[str, int]] = None

    def resolve(self) -> "Mark":
        if self.values is None:
            ev, self.events = self.events, None
            if ev is not None:
                self.device_ms = ev.elapsed()
            c, self.counts = self.counts, None
            vals = c.read() if hasattr(c, "read") else \
                {k: int(v) for k, v in (c or {}).items()}
            if vals is not None and self.derive is not None:
                vals = self.derive(vals)
            self.values = vals or {}
            self.derive = None
        return self


class _NullSpan:
    """The shared do-nothing context manager handed out while nothing
    records: no per-call allocation on the disabled path."""

    __slots__ = ()
    active = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def count(self, **counts) -> None:
        pass

    def derive(self, fn) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "trace_id", "args", "t0", "id",
                 "parent", "_token", "_counts", "_derive", "_stack")
    active = True

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[int], args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.args = args
        self._counts = None
        self._derive = None

    def count(self, **counts) -> None:
        """Attach counters to the span: numbers, or 0-d int32 device
        tensors, which the torch side copies out without waiting and
        :func:`resolve` reads. Guard the work that makes them with ``if
        span.active``, so a disabled span adds no kernel."""
        if self._counts is None:
            self._counts = counts
        else:
            self._counts.update(counts)

    def derive(self, fn) -> None:
        """``fn(values) -> values``: the span's counters as
        :func:`resolve` reports them, worked out on the host from the
        raw ones it read."""
        self._derive = fn

    def __enter__(self) -> "_Span":
        self._stack = stack = self._tracer._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self._tracer._span_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter()
        hook = _hook
        self._token = hook.enter(self.name) if hook is not None else None
        return self

    def __exit__(self, *exc) -> None:
        hook = _hook
        events = hook.exit(self._token) if hook is not None else None
        dur = time.perf_counter() - self.t0
        stack = self._stack
        if stack and stack[-1] == self.id:
            stack.pop()
        counts = self._counts
        if counts and hook is not None:
            counts = hook.stage(counts)
        mark = Mark(events, counts, self._derive) \
            if events is not None or counts else None
        self._tracer._file(self.name, self.t0, dur, self.trace_id,
                           self.args, self.id, self.parent, mark)


class Tracer:
    """Fixed-capacity span ring buffer (see module doc for the
    concurrency argument). One process-wide instance normally suffices
    (:func:`get_tracer`); independent tracers compose for tests."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: List[Optional[Record]] = [None] * self.capacity
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._local = threading.local()
        self._tid_names: Dict[int, str] = {}
        self._enabled = False
        # optional tail sampler: every recorded span is also offered to
        # it, one attribute check when absent
        self._sampler = None

    # -- switch -------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """The explicit switch (:meth:`enable`); spans also record
        while a profiler does."""
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        """Turn recording on (optionally resizing — a resize discards
        already-recorded spans). Takes the clock offset the exports
        use."""
        _take_offset()
        if capacity is not None and int(capacity) != self.capacity:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            self.capacity = int(capacity)
            self.clear()
        self._enabled = True
        return self

    def disable(self) -> "Tracer":
        self._enabled = False
        return self

    def clear(self) -> None:
        """Drop every recorded span (the ring survives, emptied)."""
        # swap ring and sequence together; record() indexes a LOCAL ref
        # of the ring by its own length, so a racing writer lands its
        # record in whichever ring it grabbed, never out of bounds. A
        # racing writer may register its thread name into the old dict
        # (lost) — its spans still export, just without the name row.
        self._ring = [None] * self.capacity
        self._seq = itertools.count()
        self._tid_names = {}

    # -- recording ----------------------------------------------------------
    def new_trace_id(self) -> int:
        """A fresh correlation id (process-unique, monotonic)."""
        return next(self._ids)

    def new_global_trace_id(self) -> int:
        """A fresh correlation id safe to PROPAGATE across processes:
        the pid rides the high bits above the local counter, so two
        replicas (or a client and a replica) can each mint ids and a
        merged fleet trace still has no collisions. Same int domain as
        :meth:`new_trace_id` — span records don't care which minted
        theirs."""
        return ((os.getpid() & 0x3FFFFF) << 24) | \
            (next(self._ids) & 0xFFFFFF)

    def _stack(self) -> List[int]:
        """The ids of the spans open on the calling thread."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def record(self, name: str, t0: float, dur: float,
               trace_id: Optional[int] = None,
               args: Optional[dict] = None) -> None:
        """File one completed span from timestamps the caller already
        holds (``t0`` from ``time.perf_counter()``, ``dur`` seconds) —
        the zero-extra-clock-read form the hot paths use. Its parent is
        the span open on the calling thread, if any."""
        if not self._enabled and not _probe():
            return
        stack = self._stack()
        self._file(name, t0, dur, trace_id, args, None,
                   stack[-1] if stack else None, None)

    def _file(self, name, t0, dur, trace_id, args, span, parent,
              mark) -> None:
        tid = threading.get_ident()
        if tid not in self._tid_names:
            self._tid_names[tid] = threading.current_thread().name
        ring = self._ring
        ring[next(self._seq) % len(ring)] = (
            name, tid, t0, dur, trace_id, args, span, parent, mark)
        s = self._sampler
        if s is not None:
            s.offer(name, tid, t0, dur, trace_id, args)

    def span(self, name: str, trace_id: Optional[int] = None,
             args: Optional[dict] = None):
        """Context manager timing its block into one record; the shared
        no-op instance when nothing records: tracing is off and no
        profiler records on this thread. A span opened inside another on
        the same thread is its child."""
        if not self._enabled and not _probe():
            return _NULL_SPAN
        return _Span(self, name, trace_id, args)

    def set_sampler(self, sampler) -> None:
        """Attach (or, with ``None``, detach) a tail sampler — an
        object whose ``offer(name, tid, t0, dur, trace_id, args)`` is
        called for every recorded span. ``tailsampling.TailSampler``
        is the in-tree one; ``clear()`` leaves the attachment alone."""
        self._sampler = sampler

    def sampler(self):
        return self._sampler

    # -- reading / export ---------------------------------------------------
    def __len__(self) -> int:
        return sum(1 for r in self._ring if r is not None)

    def records(self) -> List[Record]:
        """Chronological snapshot of the retained spans (<= capacity;
        the ring keeps the most recent ones once wrapped)."""
        recs = [r for r in self._ring if r is not None]
        recs.sort(key=lambda r: r[2])
        return recs

    def export_chrome_trace(self, path: str,
                            replica: Optional[str] = None) -> int:
        """Write the retained spans as Chrome trace-event JSON (the
        format Perfetto / ``chrome://tracing`` load). Returns the number
        of span events written. ``ts`` is on the profiler's clock: Unix
        microseconds less the document's ``baseTimeNanoseconds`` (see
        the module doc), so the file merges with a ``torch.profiler``
        trace of the same run.

        Every event carries this process's real ``pid`` and the export
        leads with a ``process_name`` metadata row (``replica`` arg,
        else the process replica label, else ``pid <n>``) — so N
        replicas' exports merged into one file
        (:func:`merge_chrome_traces`) render one labeled process track
        group each instead of collapsing into anonymous processes. A
        span's ``args`` add its ``span`` and ``parent`` ids, and, once
        :func:`resolve` has read its mark, ``device_ms`` and its
        counters."""
        pid = os.getpid()
        label = replica if replica is not None else _replica
        # copy before iterating: recorder threads (pipeline workers, a
        # live coalescer) may register a first-seen tid mid-export —
        # iterating the live dict would raise and lose the whole trace
        events: List[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": label or f"pid {pid}"}}]
        events += [
            {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
             "args": {"name": tname}}
            for tid, tname in sorted(self._tid_names.copy().items())]
        recs = self.records()
        base = (unix_ns(recs[0][2]) // 1000) * 1000 if recs else \
            (unix_ns(time.perf_counter()) // 1000) * 1000
        for name, tid, t0, dur, trace_id, args, sid, parent, mark in recs:
            ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
                  "cat": name.split(".", 1)[0],
                  "ts": round((unix_ns(t0) - base) / 1e3, 3),
                  "dur": round(max(dur, 0.0) * 1e6, 3)}
            a = dict(args) if args else {}
            if trace_id is not None:
                a["trace_id"] = trace_id
            if sid is not None:
                a["span"] = sid
            if parent is not None:
                a["parent"] = parent
            if mark is not None and mark.values is not None:
                if mark.device_ms is not None:
                    a["device_ms"] = round(mark.device_ms, 6)
                a.update(mark.values)
            if a:
                ev["args"] = a
            events.append(ev)
        with open(path, "w") as f:
            # default=str: span args may carry numpy scalars etc.; a
            # lossy string beats a failed export
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base}, f, default=str)
        return len(recs)


# -- the clock ----------------------------------------------------------------

_offset_ns: Optional[int] = None


def _take_offset() -> int:
    """Take the ``perf_counter``-to-Unix offset in nanoseconds."""
    global _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    return _offset_ns


def unix_ns(t: float) -> int:
    """A ``time.perf_counter()`` reading as Unix nanoseconds, through
    the offset taken at :func:`enable` (or here, the first time)."""
    off = _offset_ns if _offset_ns is not None else _take_offset()
    return off + int(round(t * 1e9))


# -- reading what spans measured --------------------------------------------


def resolve(recs: Sequence[Record]) -> List[Record]:
    """Read the device events and counters of ``recs`` (each mark once).
    The caller must have synchronised with the device: an event the
    stream has not reached cannot be read. Returns ``recs``."""
    for r in recs:
        if r[8] is not None:
            r[8].resolve()
    return list(recs)


def units(recs: Sequence[Record], root: str,
          n: Optional[int] = None) -> List[List[Record]]:
    """The first ``n`` (default all) spans named ``root`` with no
    parent, in time order, each with every record under it: one list a
    unit of work, the root first."""
    recs = sorted(recs, key=lambda r: r[2])
    roots = [r for r in recs if r[0] == root and r[7] is None
             and r[6] is not None]
    if n is not None:
        roots = roots[:n]
    kids: Dict[int, List[Record]] = {}
    for r in recs:
        if r[7] is not None:
            kids.setdefault(r[7], []).append(r)
    out = []
    for r in roots:
        unit, todo = [r], [r[6]]
        while todo:
            for c in kids.get(todo.pop(), ()):
                unit.append(c)
                if c[6] is not None:
                    todo.append(c[6])
        out.append(unit)
    return out


def span_table(recs: Sequence[Record]) -> Dict[str, dict]:
    """Fold records into one row a span name: ``calls``, ``host_ms``
    (summed durations), ``self_ms`` (host ms less the host ms of the
    spans directly under them), ``device_ms`` (summed device extents of
    resolved marks; None where no record of the name has one) and each
    counter, summed. Unresolved marks count no device time or
    counter."""
    child_ms: Dict[int, float] = {}
    for r in recs:
        if r[7] is not None:
            child_ms[r[7]] = child_ms.get(r[7], 0.0) + r[3] * 1e3
    out: Dict[str, dict] = {}
    for name, _tid, _t0, dur, _trace, _args, sid, _p, mark in recs:
        row = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                    "self_ms": 0.0, "device_ms": None})
        row["calls"] += 1
        row["host_ms"] += dur * 1e3
        row["self_ms"] += dur * 1e3 - child_ms.get(sid, 0.0) \
            if sid is not None else dur * 1e3
        if mark is not None and mark.values is not None:
            if mark.device_ms is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) \
                    + mark.device_ms
            for k, v in mark.values.items():
                row[k] = row.get(k, 0) + v
    return out


# -- the process-default tracer ---------------------------------------------

_tracer = Tracer(int(os.environ.get("QT_TRACE_CAPACITY",
                                    str(DEFAULT_CAPACITY))))


def get_tracer() -> Tracer:
    """The process-default :class:`Tracer` every in-tree hook records
    into."""
    return _tracer


def enabled() -> bool:
    return _tracer._enabled


def enable(capacity: Optional[int] = None) -> Tracer:
    return _tracer.enable(capacity)


def disable() -> Tracer:
    return _tracer.disable()


def clear() -> None:
    _tracer.clear()


def new_trace_id() -> int:
    return _tracer.new_trace_id()


def new_global_trace_id() -> int:
    return _tracer.new_global_trace_id()


def per_unit(root: str, n: int, name: Optional[str] = None,
             field: str = "device_ms",
             recs: Optional[Sequence[Record]] = None) -> Optional[float]:
    """``field`` of :func:`span_table` (``device_ms``, ``host_ms``,
    ``self_ms`` or a counter) summed over the spans named ``name``
    (default ``root``) in the first ``n`` units of ``root``
    (:func:`units`), over ``n``: the mean a unit. Reads ``recs``
    (default the process tracer's ring) and resolves their marks, so
    the caller must have synchronised with the device. None when there
    are fewer than ``n`` units, or no such span carries the field."""
    if n <= 0:
        return None
    got = units(records() if recs is None else recs, root, n)
    if len(got) < n:
        return None
    flat = [r for u in got for r in u]
    row = span_table(resolve(flat)).get(name or root)
    v = row.get(field) if row is not None else None
    return None if v is None else v / n


# -- cross-process propagation ------------------------------------------------


def inject(carrier: Optional[dict] = None,
           trace_id: Optional[int] = None,
           parent: Optional[str] = None,
           replica: Optional[str] = None) -> dict:
    """Stamp a compact trace context into ``carrier`` (request
    metadata — any JSON-able dict; created when ``None``) and return
    it. ``trace_id`` defaults to a fresh GLOBAL id
    (:func:`new_global_trace_id` — pid-prefixed, collision-free across
    a fleet); ``replica`` defaults to this process's label. The
    receiving process hands the carrier to :func:`extract` (or to
    ``MicroBatchServer.submit(node_id, context=carrier)``) and its
    spans continue under the same ``trace_id``."""
    if carrier is None:
        carrier = {}
    carrier[CTX_TRACE_ID] = int(trace_id) if trace_id is not None \
        else new_global_trace_id()
    if parent is not None:
        carrier[CTX_PARENT] = str(parent)
    label = replica if replica is not None else _replica
    if label is not None:
        carrier[CTX_REPLICA] = str(label)
    return carrier


def extract(carrier) -> Optional[TraceContext]:
    """Read a trace context out of request metadata. Tolerant by
    design: ``None``, a non-dict, a dict without the context keys, or
    a mangled id all return ``None`` — a request without a usable
    context is simply untraced, never an error."""
    if not isinstance(carrier, dict):
        return None
    raw = carrier.get(CTX_TRACE_ID)
    try:
        tid = int(raw)
    except (TypeError, ValueError):
        return None
    parent = carrier.get(CTX_PARENT)
    replica = carrier.get(CTX_REPLICA)
    return TraceContext(tid,
                        str(parent) if parent is not None else None,
                        str(replica) if replica is not None else None)


def merge_chrome_traces(paths: Sequence[str], out_path: str) -> int:
    """Merge N per-process Chrome trace exports into ONE file Perfetto
    loads whole — the fleet view: one process track group per replica
    (each export's ``process_name`` metadata row names it), request
    spans correlated across groups by the propagated ``trace_id``.
    Two exports claiming the same pid (pid reuse across hosts or
    restarts) are disambiguated by offsetting the later file's pids —
    labels and intra-file structure are preserved. Returns the total
    number of events written. Files that fail to parse are skipped (a
    half-written export from a dying replica must not lose the rest
    of the fleet's trace).

    Files that name their clock's base (``baseTimeNanoseconds``: this
    module's exports, ``torch.profiler``'s) are rebased onto the
    earliest such base, which the merged file names, so spans of one
    host line up across them; files without one keep their ``ts``."""
    docs = []
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
            evs = doc["traceEvents"] if isinstance(doc, dict) else doc
            if not isinstance(evs, list):
                continue
        except (OSError, ValueError, KeyError):
            continue
        b = doc.get("baseTimeNanoseconds") if isinstance(doc, dict) \
            else None
        docs.append((evs, int(b) if isinstance(b, (int, float)) else None))
    bases = [b for _, b in docs if b is not None]
    base = min(bases) if bases else None
    events: List[dict] = []
    used_pids: set = set()
    for evs, b in docs:
        file_pids = {e.get("pid") for e in evs
                     if isinstance(e, dict) and "pid" in e}
        remap: Dict[int, int] = {}
        for fp in sorted(x for x in file_pids if isinstance(x, int)):
            np_ = fp
            while np_ in used_pids:
                np_ += 1 << 22          # above the pid namespace
            remap[fp] = np_
            used_pids.add(np_)
        for e in evs:
            if not isinstance(e, dict):
                continue
            e = dict(e)
            if isinstance(e.get("pid"), int):
                e["pid"] = remap.get(e["pid"], e["pid"])
            if b is not None and b != base and \
                    isinstance(e.get("ts"), (int, float)):
                e["ts"] = round(e["ts"] + (b - base) / 1e3, 3)
            events.append(e)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if base is not None:
        out["baseTimeNanoseconds"] = base
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)
    return len(events)


def record(name: str, t0: float, dur: float,
           trace_id: Optional[int] = None,
           args: Optional[dict] = None) -> None:
    _tracer.record(name, t0, dur, trace_id, args)


def span(name: str, trace_id: Optional[int] = None,
         args: Optional[dict] = None):
    return _tracer.span(name, trace_id, args)


def records() -> List[Record]:
    return _tracer.records()


def export_chrome_trace(path: str, replica: Optional[str] = None) -> int:
    return _tracer.export_chrome_trace(path, replica=replica)


# QT_TRACE=1 turns recording on; QT_TRACE=<path> additionally exports
# the ring to <path> at interpreter exit (the no-code-changes workflow:
# QT_TRACE=trace.json python train.py)
_env = os.environ.get("QT_TRACE", "")
if _env and _env.lower() not in ("0", "false", "no", "off"):
    _tracer.enable()
    if _env.lower() not in ("1", "true", "yes", "on"):
        atexit.register(_tracer.export_chrome_trace, _env)
