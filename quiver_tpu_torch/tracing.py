"""Host-side span tracing: a lock-cheap ring buffer and a Chrome/Perfetto
export (the port's own copy of ``quiver_tpu/tracing.py``; stdlib only).

Span names, the record layout and the export format are the JAX
package's, so one trace viewer reads both packages' traces. Device time
is ``torch.profiler``'s; these spans time host work around the card's
launches (the staging pipeline's ``pipeline.queue_wait`` and
``pipeline.execute``, a training loop's ``train.step``).

1. **Zero cost when off.** Tracing is opt-in (``QT_TRACE=1``,
   ``QT_TRACE=/path/out.json`` or :func:`enable`); disabled, ``record``
   is one attribute check and ``span`` hands out a shared no-op context
   manager.
2. **Lock-cheap when on.** Records land in a fixed-capacity ring: one
   ``next(itertools.count())`` for the slot and one list store for the
   record. When the ring wraps, the oldest spans are overwritten.
3. **No device synchronisation.** Nothing here reads a tensor.

A span record is ``(name, tid, t0, dur, trace_id, args)``: ``t0`` and
``dur`` in ``time.perf_counter()`` seconds, ``tid`` the recording
thread, ``trace_id`` an optional correlation id, ``args`` a small
JSON-able dict. :func:`export_chrome_trace` writes Chrome trace-event
JSON; :func:`inject` and :func:`extract` carry a trace context across
processes in request metadata, and :func:`merge_chrome_traces` joins
several processes' exports into one file.

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
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

Record = Tuple[str, int, float, float, Optional[int], Optional[dict]]

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


class _NullSpan:
    """The shared do-nothing context manager handed out while tracing
    is disabled — no per-call allocation on the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "trace_id", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[int], args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.args = args

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.record(self.name, self.t0,
                            time.perf_counter() - self.t0,
                            self.trace_id, self.args)


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
        self._tid_names: Dict[int, str] = {}
        self._enabled = False
        # optional tail sampler: every recorded span is also offered to
        # it, one attribute check when absent
        self._sampler = None

    # -- switch -------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        """Turn recording on (optionally resizing — a resize discards
        already-recorded spans)."""
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

    def record(self, name: str, t0: float, dur: float,
               trace_id: Optional[int] = None,
               args: Optional[dict] = None) -> None:
        """File one completed span from timestamps the caller already
        holds (``t0`` from ``time.perf_counter()``, ``dur`` seconds) —
        the zero-extra-clock-read form the hot paths use."""
        if not self._enabled:
            return
        tid = threading.get_ident()
        if tid not in self._tid_names:
            self._tid_names[tid] = threading.current_thread().name
        ring = self._ring
        ring[next(self._seq) % len(ring)] = (
            name, tid, t0, dur, trace_id, args)
        s = self._sampler
        if s is not None:
            s.offer(name, tid, t0, dur, trace_id, args)

    def span(self, name: str, trace_id: Optional[int] = None,
             args: Optional[dict] = None):
        """Context manager timing its block into one record; the shared
        no-op instance when disabled."""
        if not self._enabled:
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
        of span events written. Timestamps are ``perf_counter``-relative
        microseconds — offsets within the trace are what matter.

        Every event carries this process's real ``pid`` and the export
        leads with a ``process_name`` metadata row (``replica`` arg,
        else the process replica label, else ``pid <n>``) — so N
        replicas' exports merged into one file
        (:func:`merge_chrome_traces`) render one labeled process track
        group each instead of collapsing into anonymous processes."""
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
        for name, tid, t0, dur, trace_id, args in recs:
            ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
                  "cat": name.split(".", 1)[0],
                  "ts": round(t0 * 1e6, 3),
                  "dur": round(max(dur, 0.0) * 1e6, 3)}
            a = dict(args) if args else {}
            if trace_id is not None:
                a["trace_id"] = trace_id
            if a:
                ev["args"] = a
            events.append(ev)
        with open(path, "w") as f:
            # default=str: span args may carry numpy scalars etc.; a
            # lossy string beats a failed export
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, default=str)
        return len(recs)


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
    of the fleet's trace)."""
    events: List[dict] = []
    used_pids: set = set()
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
            evs = doc["traceEvents"] if isinstance(doc, dict) else doc
            if not isinstance(evs, list):
                continue
        except (OSError, ValueError, KeyError):
            continue
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
            events.append(e)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                  f, default=str)
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
