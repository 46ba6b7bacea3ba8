"""Tail-based trace sampling and fleet trace assembly (counterpart of
``quiver_tpu/tailsampling.py``; the same keep decisions and records).

Every request's spans are buffered while it is in flight, and the keep
or drop decision is taken when its outcome is known: an error, a blown
deadline, a latency over the live p99 threshold, an armed anomaly
window, or a seeded probabilistic floor. Kept traces go out as
``trace`` JSONL records through a ``metrics.MetricsSink``, and the
fleet aggregator joins a client's ``rpc.*`` spans and a replica's
``serve.*`` spans by their global ``trace_id``.

- :class:`TailSampler` attaches to a ``tracing.Tracer``
  (:meth:`TailSampler.attach`; every recorded span is offered to it).
  Spans gather per ``trace_id`` in a bounded pending table (the oldest
  incomplete trace is evicted when it is full; evictions and truncated
  spans are counted). A trace completes when its root span arrives
  (``serve.request`` on a replica, ``rpc.lookup`` on a client), and the
  policy chain (:data:`TAIL_POLICY_NAMES`, first match keeps) decides:

  | policy | keeps when |
  |---|---|
  | ``error`` | a span carries an ``error`` arg other than a deadline |
  | ``deadline_exceeded`` | a span's ``error`` is ``DeadlineExceeded`` |
  | ``latency_over_p99`` | the root's duration exceeds ``latency_source()`` |
  | ``anomaly_window`` | the trace completed inside an armed anomaly window |
  | ``head_sample`` | the seeded floor (``head_rate``) |

  Batch spans (``serve.batch_coalesce``, ``serve.dispatch``,
  ``serve.scatter``; their ``trace_id`` is a batch id) live in a small
  buffer of their own and join a kept request trace through the root
  span's ``batch`` arg.
- :func:`assemble` and :class:`TraceStore` group kept records by
  ``trace_id`` across sources and merge them: each segment's critical
  path, the dominant span across segments, and the queue-versus-execute
  split. Segments keep their own time bases (``perf_counter`` per
  process): correlation is by id, never by clock.
- :func:`trace_record_to_chrome_events` turns one kept segment into
  Chrome trace events (``tracing.merge_chrome_traces`` joins them).
  A kept record's ``base_ns`` is its first span's start in Unix
  nanoseconds (``tracing.unix_ns``): the events' ``ts`` are Unix
  microseconds less that base, the profiler's clock convention, so a
  file of them that names it as ``baseTimeNanoseconds`` merges onto
  the host's other traces.

Standard library only. The sampler never emits under its own lock, and
a span costs one append under one lock.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import tracing

__all__ = ["TAIL_POLICY_NAMES", "TailSampler", "TraceStore", "assemble",
           "critical_path", "latency_source_from",
           "trace_record_to_chrome_events"]

#: the keep policies, in evaluation order (first match wins)
TAIL_POLICY_NAMES = ("error", "deadline_exceeded", "latency_over_p99",
                     "anomaly_window", "head_sample")

#: span names that COMPLETE a trace (the request's terminal span on
#: each side of the wire)
DEFAULT_ROOT_SPANS = ("serve.request", "rpc.lookup")

#: batch-scoped span names: their trace_id is a serving BATCH id (the
#: ``batch`` arg request spans carry), buffered separately and merged
#: into kept request traces — never pending-table entries
BATCH_SPAN_NAMES = ("serve.batch_coalesce", "serve.dispatch",
                    "serve.scatter")

#: the queue-vs-execute split vocabulary (the profile/costmodel
#: framing: time spent WAITING vs time spent DOING)
QUEUE_SPAN_NAMES = ("serve.admission_wait", "serve.coalesce_wait",
                    "pipeline.queue_wait", "rpc.backoff")
EXECUTE_SPAN_NAMES = ("serve.dispatch", "pipeline.execute",
                      "rpc.attempt", "rpc.hedge", "serve.scatter")


def latency_source_from(slo=None, stats=None,
                        floor_ms: float = 0.0) -> Callable[[], Optional[float]]:
    """A ``latency_source`` callable for the ``latency_over_p99``
    policy, fed by the LIVE serving windows: the SLO's latency target
    when a ``metrics.SloBudget`` is armed (the number the burn rate is
    charged against), else the observed per-request p99 from a
    ``metrics.StepStats`` (``request_p99_ms()`` — so "over p99" is
    literal: the trace ran slower than 99% of its recent peers).
    Duck-typed: this module imports neither torch nor ``metrics``."""
    def source() -> Optional[float]:
        if slo is not None:
            return max(float(slo.target_p99_ms), floor_ms)
        if stats is not None:
            p99 = stats.request_p99_ms()
            return None if p99 is None else max(float(p99), floor_ms)
        return None
    return source


class TailSampler:
    """Bounded per-trace span buffer + outcome-driven keep policy.

    - ``sink``: anything with ``emit(record, kind=)`` (a
      ``metrics.MetricsSink``); kept traces emit as kind ``trace``.
    - ``max_pending``: pending-trace table capacity. The table LRU-
      evicts the oldest INCOMPLETE trace when full (``evicted``
      counted); a root span arriving for an evicted trace re-opens it
      with only the spans seen since, so a kept verdict still fires —
      just on a truncated timeline.
    - ``max_spans_per_trace``: per-trace span bound (``truncated_spans``
      counted past it).
    - ``latency_source``: zero-arg callable returning the live
      ``latency_over_p99`` threshold in ms (None disables the policy)
      — see :func:`latency_source_from`.
    - ``head_rate``: the probabilistic head-sampling floor (seeded —
      reproducible).
    - ``anomaly_window_s``: how long :meth:`arm_anomaly_window` keeps
      everything after a detector firing.

    Thread-safe; policy decisions run under the table lock, sink
    emission strictly outside it."""

    def __init__(self, sink=None, max_pending: int = 512,
                 max_spans_per_trace: int = 64,
                 latency_source: Optional[Callable[[], Optional[float]]] = None,
                 head_rate: float = 0.0,
                 anomaly_window_s: float = 30.0,
                 root_spans: Sequence[str] = DEFAULT_ROOT_SPANS,
                 max_batches: int = 64,
                 seed: int = 0, clock=None,
                 on_keep: Optional[Callable[[dict], None]] = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if not 0.0 <= float(head_rate) <= 1.0:
            raise ValueError(f"head_rate must be in [0, 1], got {head_rate}")
        self.sink = sink
        self.max_pending = int(max_pending)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.latency_source = latency_source
        self.head_rate = float(head_rate)
        self.anomaly_window_s = float(anomaly_window_s)
        self.root_spans = tuple(root_spans)
        self.max_batches = int(max_batches)
        self.on_keep = on_keep
        self._clock = clock if clock is not None else time.monotonic
        self._rng = random.Random(seed)
        self._pending: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self._batches: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self._anomaly_until = 0.0
        self._lock = threading.Lock()
        self._kept = 0
        self._dropped = 0
        self._evicted = 0
        self._truncated = 0
        self._offered = 0
        self._high_water = 0
        self._by_policy: Dict[str, int] = {}
        self._tracer: Optional[tracing.Tracer] = None

    # -- tracer wiring -------------------------------------------------------
    def attach(self, tracer: Optional[tracing.Tracer] = None) -> "TailSampler":
        """Hook this sampler into ``tracer`` (the process default when
        None) and ENABLE it — always-on tail sampling is "tracing on,
        keep only what the outcome earns"."""
        t = tracer if tracer is not None else tracing.get_tracer()
        t.set_sampler(self)
        t.enable()
        self._tracer = t
        return self

    def detach(self) -> None:
        """Unhook from the tracer (recording stays enabled — the ring
        is the caller's; disable it separately if wanted)."""
        t = self._tracer
        if t is not None and t.sampler() is self:
            t.set_sampler(None)
        self._tracer = None

    # -- the per-span hot path -----------------------------------------------
    def offer(self, name: str, tid: int, t0: float, dur: float,
              trace_id: Optional[int], args: Optional[dict]) -> None:
        """One recorded span (the tracer calls this for every record
        while attached). Spans without a ``trace_id`` are not
        request-scoped and are ignored."""
        if trace_id is None:
            return
        rec = None
        with self._lock:
            self._offered += 1
            if name in BATCH_SPAN_NAMES:
                buf = self._batches.get(trace_id)
                if buf is None:
                    if len(self._batches) >= self.max_batches:
                        self._batches.popitem(last=False)
                    buf = self._batches[trace_id] = []
                buf.append((name, t0, dur, args))
                return
            root = name in self.root_spans
            buf = self._pending.get(trace_id)
            if buf is None and root:
                # root-only completion (the trace was evicted earlier,
                # or its terminal span is its only span): decide on a
                # local buffer WITHOUT occupying the table — inserting
                # just to delete in the same call would evict a LIVE
                # in-flight trace for nothing
                rec = self._decide_locked(
                    trace_id, [(name, t0, dur, args)], name, dur, args)
            else:
                if buf is None:
                    if len(self._pending) >= self.max_pending:
                        # LRU-evict the oldest incomplete trace:
                        # bounded memory beats a complete table; the
                        # loss is COUNTED, never silent
                        self._pending.popitem(last=False)
                        self._evicted += 1
                    buf = self._pending[trace_id] = []
                    if len(self._pending) > self._high_water:
                        self._high_water = len(self._pending)
                else:
                    self._pending.move_to_end(trace_id)
                if len(buf) >= self.max_spans_per_trace and not root:
                    # the ROOT span is exempt: the outcome (error arg,
                    # duration) is the whole basis of the keep decision
                    # — truncating it would silently drop a bad trace
                    self._truncated += 1
                else:
                    buf.append((name, t0, dur, args))
                if root:
                    del self._pending[trace_id]
                    rec = self._decide_locked(trace_id, buf, name,
                                              dur, args)
        # emission strictly OUTSIDE the lock: a slow telemetry disk
        # must never stall the serving executor thread that recorded
        # the span
        if rec is not None:
            if self.sink is not None:
                self.sink.emit(rec, kind="trace")
            if self.on_keep is not None:
                try:
                    self.on_keep(rec)
                except Exception:
                    pass

    # -- the policy chain ----------------------------------------------------
    def _decide_locked(self, trace_id: int, spans: list, root_name: str,
                       root_dur: float, root_args) -> Optional[dict]:
        if isinstance(root_args, dict):
            bid = root_args.get("batch")
            if bid is not None and bid in self._batches:
                spans = spans + list(self._batches[bid])
        errors = [a.get("error") for (_n, _t, _d, a) in spans
                  if isinstance(a, dict) and a.get("error")]
        policy = None
        if any(e != "DeadlineExceeded" for e in errors):
            policy = "error"
        elif errors:
            policy = "deadline_exceeded"
        else:
            thr = self.latency_source() if self.latency_source else None
            if thr is not None and root_dur * 1e3 > thr:
                policy = "latency_over_p99"
            elif self._clock() < self._anomaly_until:
                policy = "anomaly_window"
            elif self.head_rate and self._rng.random() < self.head_rate:
                policy = "head_sample"
        if policy is None:
            self._dropped += 1
            return None
        self._kept += 1
        self._by_policy[policy] = self._by_policy.get(policy, 0) + 1
        spans = sorted(spans, key=lambda s: s[1])
        base = spans[0][1] if spans else 0.0
        out_spans = []
        for n, t0, dur, args in spans:
            s = {"name": n, "t0_ms": round((t0 - base) * 1e3, 3),
                 "dur_ms": round(dur * 1e3, 3)}
            if args:
                s["args"] = args
            out_spans.append(s)
        rec = {"trace_id": int(trace_id), "policy": policy,
               "root": root_name,
               "duration_ms": round(root_dur * 1e3, 3),
               "spans": out_spans, "base_ns": tracing.unix_ns(base)}
        replica = tracing.get_replica()
        if replica is not None:
            rec["replica"] = replica
        if errors:
            rec["errors"] = errors
        rec.update(critical_path(out_spans, root_name=root_name,
                                 root_dur_ms=root_dur * 1e3))
        return rec

    # -- anomaly window ------------------------------------------------------
    def arm_anomaly_window(self, duration_s: Optional[float] = None) -> None:
        """Keep every trace completing within the window — "what did
        requests look like around the regime shift" is exactly the
        question an anomaly record cannot answer alone."""
        until = self._clock() + (float(duration_s)
                                 if duration_s is not None
                                 else self.anomaly_window_s)
        with self._lock:
            if until > self._anomaly_until:
                self._anomaly_until = until

    def watch_hub(self, hub) -> "TailSampler":
        """Arm the anomaly window from a ``telemetry.TelemetryHub``'s
        detector firings (``hub.on_anomaly`` observers are called
        outside the hub lock)."""
        hub.on_anomaly.append(lambda rec: self.arm_anomaly_window())
        return self

    # -- reading -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "kept": self._kept,
                "dropped": self._dropped,
                "completed": self._kept + self._dropped,
                "evicted": self._evicted,
                "truncated_spans": self._truncated,
                "spans_offered": self._offered,
                "pending": len(self._pending),
                "pending_high_water": self._high_water,
                "pending_capacity": self.max_pending,
                "kept_by_policy": dict(self._by_policy),
            }


# -- critical-path attribution -------------------------------------------------


def critical_path(spans: Sequence[dict], root_name: Optional[str] = None,
                  root_dur_ms: Optional[float] = None) -> dict:
    """Dominant span + queue-vs-execute split over ``{name, dur_ms}``
    span dicts (one kept-trace segment, or an assembled union). The
    dominant span is the longest NON-root span — the single place the
    time went; its ``share`` is of the root duration when known."""
    dominant = None
    queue_ms = 0.0
    execute_ms = 0.0
    for s in spans:
        name = s.get("name")
        dur = float(s.get("dur_ms") or 0.0)
        if name in QUEUE_SPAN_NAMES:
            queue_ms += dur
        elif name in EXECUTE_SPAN_NAMES:
            execute_ms += dur
        if name != root_name and name not in DEFAULT_ROOT_SPANS:
            if dominant is None or dur > dominant["dur_ms"]:
                dominant = {"name": name, "dur_ms": round(dur, 3)}
    if dominant is not None and root_dur_ms:
        dominant["share"] = round(dominant["dur_ms"] / root_dur_ms, 4)
    return {"dominant": dominant,
            "queue_ms": round(queue_ms, 3),
            "execute_ms": round(execute_ms, 3)}


# -- fleet assembly ------------------------------------------------------------


def assemble(trace_id: int, segments: Sequence[dict]) -> dict:
    """Stitch one trace's kept segments (the per-process ``trace``
    records sharing a global ``trace_id``) into the fleet view. Each
    segment keeps its own ``perf_counter`` time base (fleet clocks
    disagree — correlation is by id, never by clock); the assembled
    record carries the cross-segment dominant span, the summed
    queue/execute split, and the end-to-end duration (the client
    segment's root covers the whole remote call, so the max root
    duration is the trace's)."""
    segs = sorted(segments, key=lambda r: (r.get("root") or "",
                                           r.get("replica") or ""))
    all_spans: List[dict] = []
    errors: List[str] = []
    for seg in segs:
        all_spans.extend(seg.get("spans") or ())
        errors.extend(seg.get("errors") or ())
    duration = max((float(s.get("duration_ms") or 0.0) for s in segs),
                   default=0.0)
    out = {
        "trace_id": int(trace_id),
        "segments": list(segs),
        "replicas": sorted({s.get("replica") or "?" for s in segs}),
        "policies": sorted({s.get("policy") or "?" for s in segs}),
        "duration_ms": round(duration, 3),
        "span_count": len(all_spans),
    }
    if errors:
        out["errors"] = errors
    out.update(critical_path(all_spans, root_dur_ms=duration or None))
    return out


class TraceStore:
    """Bounded cross-source store of kept ``trace`` records, grouped
    by ``trace_id`` (LRU over trace ids — the fleet keeps the RECENT
    window). Re-adding the same record is a no-op (the aggregator
    re-reads whole sink files every poll), keyed by ``(source,
    root)`` per trace — a client's ``rpc.lookup`` segment and a
    replica's ``serve.request`` segment coexist even when both land
    in one sink. Thread-safe (the aggregator's poll thread writes
    while exporter scrape threads read)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._traces: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._latest: Dict[Optional[str], Tuple[int, float]] = {}
        self._lock = threading.Lock()
        self.added = 0
        self.evicted = 0

    def add(self, rec: dict, source: str = "") -> bool:
        """Fold one ``trace`` record from ``source``; returns True when
        it was new."""
        tid = rec.get("trace_id")
        if tid is None:
            return False
        tid = int(tid)
        key = (str(source), rec.get("root") or "")
        with self._lock:
            ent = self._traces.get(tid)
            if ent is None:
                if len(self._traces) >= self.capacity:
                    self._traces.popitem(last=False)
                    self.evicted += 1
                ent = self._traces[tid] = {}
            else:
                self._traces.move_to_end(tid)
            if key in ent:
                return False
            ent[key] = rec
            self.added += 1
            dur = float(rec.get("duration_ms") or 0.0)
            replica = rec.get("replica") or (str(source) or None)
            self._latest[replica] = (tid, dur)
            self._latest[None] = (tid, dur)
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def trace_ids(self) -> List[int]:
        with self._lock:
            return list(self._traces)

    def get(self, trace_id: int) -> Optional[dict]:
        """The assembled view of one trace (None when unknown)."""
        with self._lock:
            ent = self._traces.get(int(trace_id))
            segs = list(ent.values()) if ent else None
        if segs is None:
            return None
        return assemble(int(trace_id), segs)

    def assembled(self, limit: Optional[int] = None) -> List[dict]:
        """Assembled traces, newest-first."""
        with self._lock:
            items = [(tid, list(ent.values()))
                     for tid, ent in reversed(self._traces.items())]
        if limit is not None:
            items = items[:int(limit)]
        return [assemble(tid, segs) for tid, segs in items]

    def latest(self, replica: Optional[str] = None) -> Optional[Tuple[int, float]]:
        """The newest kept ``(trace_id, duration_ms)`` for a replica
        (None = fleet-wide) — what the ``/metrics`` exemplars point
        at."""
        with self._lock:
            return self._latest.get(replica)


# -- Perfetto export -----------------------------------------------------------


def trace_record_to_chrome_events(rec: dict, pid: int = 1) -> List[dict]:
    """One kept-trace segment -> Chrome trace-event JSON events (the
    per-process half ``tracing.merge_chrome_traces`` joins into the
    fleet view)."""
    label = rec.get("replica") or f"trace {rec.get('trace_id')}"
    events: List[dict] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": str(label)}}]
    for s in rec.get("spans") or ():
        ev = {"ph": "X", "pid": pid, "tid": 1,
              "name": s.get("name", "?"),
              "cat": str(s.get("name", "?")).split(".", 1)[0],
              "ts": round(float(s.get("t0_ms") or 0.0) * 1e3, 3),
              "dur": round(max(float(s.get("dur_ms") or 0.0), 0.0) * 1e3,
                           3)}
        args = dict(s.get("args") or {})
        args["trace_id"] = rec.get("trace_id")
        ev["args"] = args
        events.append(ev)
    return events
