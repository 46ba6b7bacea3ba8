"""Telemetry time series, change-point detection and advisory
re-planning from observed distributions (counterpart of
``quiver_tpu/telemetry.py``; the same series, firings and advice).

- :class:`SeriesRing`: a fixed-capacity ring time series per metric,
  with windowed mean/p50/p95 and an EWMA (bounded memory however long
  the run);
- change-point detectors (:class:`MeanShiftDetector`,
  :class:`PageHinkleyDetector`, :class:`SpikeDetector`) that turn a
  series into ``anomaly`` JSONL records when its regime shifts: a hot
  tier's hit rate collapsing, exchange fallbacks, duplicate-factor
  drift, prefetch hit drops, recompiles;
- an advisory re-planner (:meth:`TelemetryHub.replan`) that re-runs the
  planners' sizing formulas (``comm.cap_for_expected_load``, and the
  degree-mass inversion behind the hot tier's sizing) against what was
  observed and emits ``advice`` records; it actuates nothing (the
  ``actuator`` module does);
- a :class:`FlightRecorder`: on a crash or a signal, one postmortem
  JSON with the last spans, the series' tails, the counter totals and
  the latest advice.

**The device counters.** The metered steps and lookups return their
counter vector as a tensor on the card (``metrics.Collector``).
:meth:`TelemetryHub.observe_counters` and
:meth:`TelemetryHub.observe_step` never wait for it: a vector on the
card is queued behind a ``non_blocking`` copy into pinned host memory
and a CUDA event recorded after it, and a fold reads only vectors whose
event has completed, never the newest (the one of the step in flight),
as the JAX package folds lazily. So recording adds no host
synchronisation; :meth:`TelemetryHub.flush` and the read paths wait.
:meth:`TelemetryHub.ingest_jsonl` merges other processes' sinks
(cumulative counters diffed per source, with the add/max slot rules).
"""

from __future__ import annotations

import collections
import math
import os
import signal as _signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import metrics as _metrics

#: detector kinds the hub can arm
DETECTOR_NAMES = ("mean_shift", "page_hinkley", "spike")

#: advice record keys :meth:`TelemetryHub.replan` can emit
ADVICE_KEYS = ("hot_capacity", "exchange_cap", "dedup_budget",
               "batch_cap", "max_wait_ms", "io_workers",
               "partitions", "locality_weight")


# -- the per-metric ring time-series ----------------------------------------


class SeriesRing:
    """Fixed-capacity scalar time-series: append is O(1), memory is
    ``capacity`` floats forever (a week-long run cannot grow it). Reads reconstruct chronological order from the write cursor;
    ``window_stats`` gives the recent-window mean/p50/p95 and
    ``ewma`` the exponentially-weighted level the detectors and the
    advisor consume."""

    def __init__(self, capacity: int = 512):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, np.float64)
        self._n = 0                      # total points ever appended

    def append(self, value: float) -> None:
        self._buf[self._n % self.capacity] = float(value)
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        """Points ever appended (>= ``len`` once wrapped)."""
        return self._n

    @property
    def wrapped(self) -> bool:
        return self._n > self.capacity

    def values(self) -> np.ndarray:
        """Chronological copy of the retained points (oldest first)."""
        if self._n <= self.capacity:
            return self._buf[:self._n].copy()
        cut = self._n % self.capacity
        return np.concatenate([self._buf[cut:], self._buf[:cut]])

    def last(self) -> Optional[float]:
        if not self._n:
            return None
        return float(self._buf[(self._n - 1) % self.capacity])

    def ewma(self, alpha: float = 0.3) -> Optional[float]:
        v = self.values()
        if not v.size:
            return None
        level = v[0]
        for x in v[1:]:
            level += alpha * (x - level)
        return float(level)

    def window_stats(self, window: int = 16) -> Optional[dict]:
        """Mean/p50/p95/min/max over the most recent ``window`` points
        (``None`` while empty)."""
        v = self.values()
        if not v.size:
            return None
        w = v[-int(window):]
        return {
            "n": int(w.size),
            "mean": float(w.mean()),
            "p50": float(np.percentile(w, 50)),
            "p95": float(np.percentile(w, 95)),
            "min": float(w.min()),
            "max": float(w.max()),
        }


# -- change-point detectors --------------------------------------------------


class MeanShiftDetector:
    """Windowed mean-shift test: compare the mean of the most recent
    ``window`` points against the mean of the ``window`` points before
    them; fire when the shift exceeds ``max(min_abs, threshold *
    |reference mean|)`` in the watched ``direction``. O(2*window)
    state; re-arms by resetting its history after firing, so a
    sustained new regime raises ONE anomaly, not one per step."""

    name = "mean_shift"

    def __init__(self, window: int = 8, threshold: float = 0.25,
                 min_abs: float = 0.02, direction: str = "both"):
        if direction not in ("up", "down", "both"):
            raise ValueError(f"direction must be up|down|both, "
                             f"got {direction!r}")
        self.window = max(int(window), 2)
        self.threshold = float(threshold)
        self.min_abs = float(min_abs)
        self.direction = direction
        self._hist: "collections.deque" = collections.deque(
            maxlen=2 * self.window)

    def update(self, value: float) -> Optional[dict]:
        self._hist.append(float(value))
        if len(self._hist) < 2 * self.window:
            return None
        h = list(self._hist)
        ref = sum(h[:self.window]) / self.window
        cur = sum(h[self.window:]) / self.window
        shift = cur - ref
        gate = max(self.min_abs, self.threshold * abs(ref))
        fired = (abs(shift) > gate
                 and (self.direction == "both"
                      or (self.direction == "up" and shift > 0)
                      or (self.direction == "down" and shift < 0)))
        if not fired:
            return None
        self._hist.clear()               # re-arm on the new regime
        return {"baseline": ref, "value": cur, "shift": shift}


class PageHinkleyDetector:
    """Page–Hinkley cumulative drift test: accumulate deviations from
    the running mean (minus a ``delta`` tolerance) and fire when the
    cumulative sum strays more than ``threshold`` from its running
    extremum — the classic sequential change-point detector for slow
    drifts a windowed mean-shift smears out. Two-sided unless
    ``direction`` narrows it."""

    name = "page_hinkley"

    def __init__(self, delta: float = 0.005, threshold: float = 0.1,
                 min_samples: int = 8, direction: str = "both"):
        if direction not in ("up", "down", "both"):
            raise ValueError(f"direction must be up|down|both, "
                             f"got {direction!r}")
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = max(int(min_samples), 2)
        self.direction = direction
        self._reset()

    def _reset(self):
        self._n = 0
        self._mean = 0.0
        self._up = 0.0       # cumulative positive-drift statistic
        self._down = 0.0     # cumulative negative-drift statistic

    def update(self, value: float) -> Optional[dict]:
        value = float(value)
        self._n += 1
        self._mean += (value - self._mean) / self._n
        dev = value - self._mean
        self._up = max(0.0, self._up + dev - self.delta)
        self._down = max(0.0, self._down - dev - self.delta)
        if self._n < self.min_samples:
            return None
        fired_up = (self.direction in ("up", "both")
                    and self._up > self.threshold)
        fired_down = (self.direction in ("down", "both")
                      and self._down > self.threshold)
        if not (fired_up or fired_down):
            return None
        out = {"baseline": self._mean, "value": value,
               "shift": self._up if fired_up else -self._down}
        self._reset()                    # re-arm on the new regime
        return out


class SpikeDetector:
    """Fire on any point above ``threshold`` (or below, with
    ``direction="down"``) — the right detector for event counters that
    should be exactly zero in steady state (recompiles). One anomaly
    per offending point, no history."""

    name = "spike"

    def __init__(self, threshold: float = 0.0, direction: str = "up"):
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be up|down, "
                             f"got {direction!r}")
        self.threshold = float(threshold)
        self.direction = direction

    def update(self, value: float) -> Optional[dict]:
        value = float(value)
        if (value > self.threshold if self.direction == "up"
                else value < self.threshold):
            return {"baseline": self.threshold, "value": value,
                    "shift": value - self.threshold}
        return None


_DETECTOR_TYPES = {
    "mean_shift": MeanShiftDetector,
    "page_hinkley": PageHinkleyDetector,
    "spike": SpikeDetector,
}

#: the hub's default watch list: (series, detector kind, kwargs) — the
#: regime shifts a controller must react to
DEFAULT_WATCHES = (
    ("hot_hit_rate", "mean_shift", {"direction": "down"}),
    ("exchange_fallback_rate", "mean_shift",
     {"direction": "up", "min_abs": 0.1}),
    ("dup_factor", "page_hinkley", {"delta": 0.05, "threshold": 1.0}),
    ("prefetch_hit_rate", "mean_shift", {"direction": "down"}),
    ("recompiles", "spike", {}),
    # a staging worker dying at all is an incident worth a record —
    # the auto-replacement keeps serving, the spike says LOOK (fed by
    # ColdPrefetcher.observe_into)
    ("staging_worker_restarts", "spike", {}),
    # a stage silently growing its share of the step (the profiler's
    # stage_share:<entry>/<stage> series — a trailing * is a PREFIX
    # watch, armed lazily on every matching series as it appears)
    ("stage_share:*", "mean_shift", {"direction": "up",
                                     "min_abs": 0.05}),
)


# -- what the advisor knows about the static plan ----------------------------


class PlanContext:
    """The deployment's *planned* capacities — what
    :meth:`TelemetryHub.replan` re-derives from observation. Every
    field is optional; advice is only computed for the knobs the
    caller described.

    - ``hot_capacity`` / ``total_rows`` / ``degree`` /
      ``expected_hit_rate``: the hot tier as it was sized (``degree`` enables the exact degree-mass inversion;
      without it the advisor scales linearly).
    - ``exchange_cap`` / ``partition`` / ``frontier_cap``: the compact
      exchange as ``PartitionInfo.plan_exchange_cap`` sized it.
    - ``dedup_budget``: the unique-table budget ``dedup_cold`` /
      ``dedup_gather`` run with.
    - ``batch_cap`` / ``max_wait_ms`` / ``target_p99_ms``: the serving
      knobs (``ServeConfig``).
    - ``io_workers`` / ``io_qd``: the cold tier's parallel-IO staging
      deployment (``Feature.enable_cold_prefetch``) — how many staging
      workers shard each publication, and the reader pool's queue
      depth (the ceiling any worker recommendation respects).
    - ``partitions`` / ``locality_weight``: the sharded-serving fleet
      shape (how many partition homes the store is split across) and
      the ``HealthRouter.set_locality`` blend weight the fleet routes
      with.
    - ``slack``: the proportional headroom every recommendation carries
      (the planners' own default 1.25).
    """

    def __init__(self, hot_capacity: Optional[int] = None,
                 total_rows: Optional[int] = None,
                 degree=None,
                 expected_hit_rate: Optional[float] = None,
                 exchange_cap: Optional[int] = None,
                 partition=None,
                 frontier_cap: Optional[int] = None,
                 dedup_budget: Optional[int] = None,
                 batch_cap: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 target_p99_ms: Optional[float] = None,
                 io_workers: Optional[int] = None,
                 io_qd: Optional[int] = None,
                 partitions: Optional[int] = None,
                 locality_weight: Optional[float] = None,
                 slack: float = 1.25):
        self.hot_capacity = hot_capacity
        self.total_rows = total_rows
        self.degree = (None if degree is None
                       else np.asarray(degree, np.float64))
        self.expected_hit_rate = expected_hit_rate
        self.exchange_cap = exchange_cap
        self.partition = partition
        self.frontier_cap = frontier_cap
        self.dedup_budget = dedup_budget
        self.batch_cap = batch_cap
        self.max_wait_ms = max_wait_ms
        self.target_p99_ms = target_p99_ms
        self.io_workers = io_workers
        self.io_qd = io_qd
        self.partitions = partitions
        self.locality_weight = locality_weight
        self.slack = float(slack)


def rows_for_hit_rate(degree, target: float) -> int:
    """Smallest hot-row count whose degree-mass share reaches
    ``target`` under degree-proportional access — the inverse of the
    hit-rate model the hot tier's sizing uses forward."""
    deg = np.sort(np.asarray(degree, np.float64))[::-1]
    mass = np.cumsum(deg)
    total = mass[-1] if mass.size else 0.0
    if total <= 0:
        return 0
    idx = int(np.searchsorted(mass, min(max(target, 0.0), 1.0) * total))
    return min(idx + 1, deg.size)


# -- the hub -----------------------------------------------------------------


class TelemetryHub:
    """Rolling time-series + detection + advisory re-planning over the
    runtime telemetry. Host-side only; thread-safe; bounded memory
    (every series and the anomaly/advice logs are rings/deques).

    Feed it from wherever the signals already flow:

    - ``observe_step(dt, counters)`` / ``observe_counters(counters)``
      — the device counter vectors metered steps/lookups return
      (queued, folded lazily: zero per-step host syncs);
    - ``observe(name, value)`` — any host scalar (the serving layer's
      per-batch fill, a prefetcher's interval hit rate);
    - ``watch_compiles(...)`` — executable-cache growth becomes the
      ``recompiles`` series (any positive point is an anomaly);
    - ``ingest_snapshot`` / ``ingest_jsonl`` — other processes'
      ``step_stats`` records, counters merged cross-host with the
      add/max slot semantics;
    - ``ingest_slo`` / ``ingest_serving`` / ``ingest_prefetch`` —
      burn rates, request percentiles, staging-ring behavior.

    ``sink`` (a ``metrics.MetricsSink``) receives one ``anomaly``
    record per detector firing and one ``advice`` record per
    :meth:`replan` recommendation. Nothing is ever actuated."""

    def __init__(self, capacity: int = 512, window: int = 8,
                 fold_every: int = 32, sink=None,
                 plan: Optional[PlanContext] = None,
                 watches: Optional[Sequence] = DEFAULT_WATCHES,
                 max_log: int = 64):
        self.capacity = int(capacity)
        self.window = max(int(window), 2)
        self._fold_every = max(int(fold_every), 1)
        self.sink = sink
        self.plan = plan
        self.series: Dict[str, SeriesRing] = {}
        self._detectors: Dict[str, List] = {}
        self._prefix_watches: List[tuple] = []
        self._pending: List = []
        self._counters = np.zeros((_metrics.NUM_COUNTERS,), np.int64)
        self._steps = 0
        self._compile_fns: List = []
        self._compile_last: Optional[int] = None
        self._source_last: Dict[str, np.ndarray] = {}
        # per-source high-water marks for ingest_records/ingest_jsonl:
        # (count, fingerprint of the first kind-matching record) — how
        # many records have already been folded from each source, so
        # re-reading a growing sink file ingests only the tail (gauge
        # points would otherwise double-count — the cumulative-counter
        # diff only protects the counter slots). The fingerprint
        # detects a rollover that dropped old records while appending
        # at least as many new ones: the count alone would read that
        # as pure growth and silently skip the genuinely-new tail.
        self._ingest_marks: Dict[str, tuple] = {}
        self.anomalies: "collections.deque" = collections.deque(
            maxlen=int(max_log))
        # observers called with each anomaly record OUTSIDE the hub
        # lock (the same discipline as sink emission) — how the tail
        # sampler arms its keep-everything window on a detector firing
        # (``TailSampler.watch_hub``)
        self.on_anomaly: List[Callable[[dict], None]] = []
        self.advice: Dict[str, dict] = {}
        # detector firings queue here under the lock and emit AFTER it
        # releases — a slow sink disk must never stall every thread
        # that touches the hub (e.g. the serving executor's per-batch
        # observe() calls)
        self._emit_queue: List[tuple] = []
        self._lock = threading.Lock()
        self._report_name: Optional[str] = None
        for w in (watches or ()):
            name, kind, kw = w
            self.watch(name, kind, **kw)

    # -- series plumbing -----------------------------------------------------
    def _series(self, name: str) -> SeriesRing:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = SeriesRing(self.capacity)
            # prefix watches arm lazily: series names under a watched
            # prefix (e.g. the profiler's stage_share:<entry>/<stage>)
            # are not enumerable up front, so each new matching series
            # gets its own detector instance the moment it appears
            for prefix, cls, params in self._prefix_watches:
                if name.startswith(prefix):
                    self._detectors.setdefault(name, []).append(
                        cls(**self._detector_params(cls, params)))
        return s

    def _detector_params(self, cls, params: dict) -> dict:
        p = dict(params)
        if cls is MeanShiftDetector:
            p.setdefault("window", self.window)
        return p

    def watch(self, name: str, detector: str = "mean_shift",
              **params) -> "TelemetryHub":
        """Arm a change-point ``detector`` (one of
        ``DETECTOR_NAMES``) on series ``name``. Detectors default to
        the hub's ``window`` where they take one. A ``name`` ending in
        ``*`` is a PREFIX watch: every series whose name starts with
        the prefix gets its own detector instance when it first
        appears (existing matching series are armed immediately)."""
        try:
            cls = _DETECTOR_TYPES[detector]
        except KeyError:
            raise ValueError(
                f"unknown detector {detector!r}; "
                f"one of {DETECTOR_NAMES}") from None
        with self._lock:
            if name.endswith("*"):
                prefix = name[:-1]
                self._prefix_watches.append((prefix, cls, params))
                for existing in self.series:
                    if existing.startswith(prefix):
                        self._detectors.setdefault(existing, []).append(
                            cls(**self._detector_params(cls, params)))
            else:
                self._detectors.setdefault(name, []).append(
                    cls(**self._detector_params(cls, params)))
        return self

    def _append_locked(self, name: str, value) -> None:
        if value is None:
            return
        value = float(value)
        if math.isnan(value):
            return
        self._series(name).append(value)
        for det in self._detectors.get(name, ()):
            hit = det.update(value)
            if hit is not None:
                self._anomaly_locked(name, det.name, hit)

    def _anomaly_locked(self, name: str, detector: str,
                        hit: dict) -> None:
        rec = {
            "series": name, "detector": detector,
            "value": round(hit["value"], 6),
            "baseline": round(hit["baseline"], 6),
            "shift": round(hit["shift"], 6),
            "step": self._series(name).total,
        }
        self.anomalies.append(rec)
        if self.sink is not None or self.on_anomaly:
            self._emit_queue.append((rec, "anomaly"))

    def _drain_emits(self) -> None:
        """Emit queued records OUTSIDE the hub lock (call after every
        lock release that may have fired a detector)."""
        if self.sink is None and not self.on_anomaly:
            return
        with self._lock:
            if not self._emit_queue:
                return
            queued, self._emit_queue = self._emit_queue, []
        for rec, kind in queued:
            if self.sink is not None:
                self.sink.emit(rec, kind=kind)
            if kind == "anomaly":
                for cb in list(self.on_anomaly):
                    try:
                        cb(rec)
                    except Exception:
                        pass

    def observe(self, name: str, value) -> None:
        """Append one host scalar to series ``name`` (``None``/NaN
        points are dropped — a ratio whose denominator never moved is
        not a data point)."""
        with self._lock:
            self._append_locked(name, value)
        self._drain_emits()

    # -- the lazy device-counter path ---------------------------------------
    def observe_counters(self, counters) -> None:
        """Queue one step's counter vector (``[N]`` or a stacked
        ``[shards, N]``; a tensor on the card, on the CPU, or numpy).
        Folded lazily: the newest vector is never read on the recording
        path, and a vector on the card is read only once its copy to
        pinned memory has completed, so this never waits for the card."""
        queued = _queue(counters)
        with self._lock:
            self._pending.append(queued)
            if len(self._pending) > self._fold_every:
                self._fold_locked(keep=1)
        self._drain_emits()

    def observe_step(self, duration_s: float, counters=None) -> None:
        """One step: wall latency into the ``step_ms`` series plus the
        optional counter vector via :meth:`observe_counters`."""
        queued = None if counters is None else _queue(counters)
        with self._lock:
            self._steps += 1
            self._append_locked("step_ms", 1e3 * float(duration_s))
            if queued is not None:
                self._pending.append(queued)
                if len(self._pending) > self._fold_every:
                    self._fold_locked(keep=1)
        self._drain_emits()

    def watch_compiles(self, *fns) -> "TelemetryHub":
        """Register callables with a ``_cache_size()`` (the JAX package's
        jitted functions); each fold appends the cache's growth since
        the previous fold to the ``recompiles`` series, where the
        default ``spike`` watch turns any nonzero point into an anomaly.
        The port jits nothing (``ServeEngine.jitted_fns`` is empty): its
        counterpart of an executable cache is the kernel build module's
        loaded libraries, ``ops.kernels._build.loaded_libraries``, whose
        ``_cache_size()`` grows when a kernel source is built and loaded
        for the first time."""
        with self._lock:
            known = {id(f) for f in self._compile_fns}
            new = [f for f in fns
                   if hasattr(f, "_cache_size") and id(f) not in known]
            self._compile_fns += new
            self._compile_last = ((self._compile_last or 0)
                                  + sum(f._cache_size() for f in new))
        return self

    def _fold_locked(self, keep: int = 0) -> None:
        # keep=1 on the recording path: the newest vector belongs to the
        # step in flight. Older vectors on the card are folded only once
        # their copy completed, in order; the read paths (keep=0) wait.
        if keep:
            ready = 0
            for q in self._pending[:-keep]:
                if not q.ready():
                    break
                ready += 1
            pending = self._pending[:ready]
            self._pending = self._pending[ready:]
        else:
            pending, self._pending = self._pending, []
        for q in pending:
            vec = _metrics.reduce_counters(q.host())
            self._ingest_vec_locked(vec)
        if pending and self._compile_fns:
            total = sum(f._cache_size() for f in self._compile_fns)
            self._append_locked("recompiles", total - self._compile_last)
            self._compile_last = total

    def _ingest_vec_locked(self, vec: np.ndarray) -> None:
        """One step's int64 counter vector -> series points + running
        totals (slot add/max semantics)."""
        self._counters = np.where(_metrics._MAX_MASK_NP,
                                  np.maximum(self._counters, vec),
                                  self._counters + vec)
        for name, val in _metrics.derive(vec).items():
            self._append_locked(name, val)
        # raw per-step loads the advisor sizes headroom from
        if vec[_metrics.EXCH_BUCKET_MAX] > 0:
            self._append_locked("exchange_bucket_max",
                                vec[_metrics.EXCH_BUCKET_MAX])
        if vec[_metrics.DEDUP_CALLS] > 0:
            self._append_locked(
                "dedup_unique_per_call",
                vec[_metrics.DEDUP_UNIQUE] / vec[_metrics.DEDUP_CALLS])
        if vec[_metrics.COLD_ROWS] > 0 or vec[_metrics.HOT_ROWS] > 0:
            self._append_locked("cold_rows", vec[_metrics.COLD_ROWS])

    def flush(self) -> None:
        """Fold everything queued (including the newest vector — call
        between steps, or before reading)."""
        with self._lock:
            self._fold_locked()
        self._drain_emits()

    # -- cross-process ingestion --------------------------------------------
    def ingest_snapshot(self, rec: dict, source: str = "") -> None:
        """Fold one ``step_stats``-shaped record (a
        ``StepStats.snapshot()`` or a JSONL line from another host's
        sink). Its ``counters`` block is CUMULATIVE per source, so the
        hub diffs against the last record seen from ``source`` and
        ingests the delta with the add/max slot semantics."""
        counters = rec.get("counters")
        if not isinstance(counters, dict):
            return
        vec = _named_to_vec(counters)
        with self._lock:
            last = self._source_last.get(source)
            self._source_last[source] = vec
            if last is None:
                delta = vec
            else:
                # add slots diff; max slots carry the newest peak
                delta = np.where(_metrics._MAX_MASK_NP, vec,
                                 np.maximum(vec - last, 0))
            if delta.any():
                self._ingest_vec_locked(delta)
            wall = rec.get("wall")
            if isinstance(wall, dict) and wall.get("p50_ms"):
                self._append_locked("step_ms", wall["p50_ms"])
        self._drain_emits()

    #: the sink-file record kinds :meth:`ingest_jsonl` folds by
    #: default: counter-bearing ``step_stats``, plus the serve-side
    #: health a fleet merge needs — ``serving`` (a step_stats payload
    #: with request percentiles / queue depth / shed level), ``slo``
    #: (burn rates), and ``tenant`` (per-tenant-class burn/p99/shed —
    #: the multi-tenant accounting plane)
    INGEST_KINDS = ("step_stats", "serving", "slo", "tenant")

    def ingest_records(self, recs, source: str,
                       kinds=INGEST_KINDS) -> int:
        """Fold an already-read record list from one ``source``.
        Idempotent across re-ingests of a growing stream: the hub keeps
        a per-source high-water mark (count of kind-matching records
        already folded) and only the tail past it is ingested — calling
        this every poll interval on the same ever-longer list never
        double-counts a gauge point, and the cumulative ``counters``
        blocks additionally diff per source (:meth:`ingest_snapshot`).
        If the visible stream's PREFIX changed (a second sink rollover
        replaced ``<path>.1``, dropping the oldest records — detected
        by count shrink or a changed first-record fingerprint even
        when enough new records arrived to mask the shrink), the mark
        resets and everything visible is re-folded — counter totals
        stay exact (the diff guards them); gauge series may repeat a
        few points in that rare case.
        Returns the number of records ingested this call."""
        import json as _json
        picked = [r for r in recs if r.get("kind") in kinds]
        head = (_json.dumps(picked[0], sort_keys=True, default=str)
                if picked else None)
        with self._lock:
            mark, prev_head = self._ingest_marks.get(source, (0, None))
            if len(picked) < mark or (mark and head != prev_head):
                mark = 0                 # prefix changed: rollover
            self._ingest_marks[source] = (len(picked), head)
        fresh = picked[mark:]
        for rec in fresh:
            kind = rec.get("kind")
            if kind == "slo":
                self.ingest_slo(rec)
                continue
            if kind == "tenant":
                # per-tenant series only — a tenant record carries no
                # cumulative counters block to diff
                self.ingest_tenant(rec)
                continue
            # cumulative-diff state is per (source, kind): a sink that
            # interleaves step_stats and serving records carries TWO
            # independent cumulative counter streams (two StepStats),
            # and diffing them against each other would corrupt both
            self.ingest_snapshot(rec, source=f"{source}#{kind}")
            if kind == "serving":
                self.ingest_serving(rec)
        return len(fresh)

    def ingest_jsonl(self, path, kinds=INGEST_KINDS) -> int:
        """Fold a per-host sink file (rotated sibling ``path.1`` first,
        then ``path`` — the ``MetricsSink`` rollover seam). Returns the
        number of NEW records ingested (the per-source high-water mark
        makes repeated calls on a growing file fold only the tail —
        see :meth:`ingest_records`). This is the cross-host merge path
        for deployments that share files instead of a mesh axis."""
        return self.ingest_records(_metrics.read_jsonl(path),
                                   str(path), kinds)

    # -- subsystem feeds -----------------------------------------------------
    def ingest_slo(self, slo) -> None:
        """Series points from a ``metrics.SloBudget`` (or its
        ``snapshot()`` dict): short/long burn rates + remaining
        budget."""
        snap = slo if isinstance(slo, dict) else slo.snapshot()
        w = snap.get("windows", {})
        self.observe("slo_burn_short", w.get("short", {}).get("burn_rate"))
        self.observe("slo_burn_long", w.get("long", {}).get("burn_rate"))
        self.observe("slo_budget_remaining", snap.get("budget_remaining"))

    def ingest_serving(self, server_or_snapshot) -> None:
        """Series points from a ``serving.MicroBatchServer`` (or its
        ``snapshot()``): per-request p99, queue depth, shed level, mean
        batch fill. (A server constructed with ``hub=`` feeds finer
        per-batch points itself.)"""
        snap = (server_or_snapshot
                if isinstance(server_or_snapshot, dict)
                else server_or_snapshot.snapshot())
        req = snap.get("request")
        if isinstance(req, dict):
            self.observe("serve_request_p99_ms", req.get("p99_ms"))
        sv = snap.get("serving", {})
        self.observe("serve_queue_depth", sv.get("queue_depth"))
        self.observe("serve_shed_level", sv.get("shed_level"))
        self.observe("serve_batch_fill", sv.get("mean_batch_fill"))
        if "slo" in snap:
            self.ingest_slo(snap["slo"])

    def ingest_tenant(self, rec: dict) -> None:
        """Series points from one ``serving`` per-tenant record (a
        ``MicroBatchServer.tenant_snapshots()`` entry / kind ``tenant``
        JSONL line): per-class p99, cumulative shed total, and — when
        the class declares an SLO — the short-window burn rate. Series
        names carry the tenant as a ``:<name>`` suffix, the same
        per-key discipline the fleet aggregator's Prometheus export
        re-labels into ``{tenant=...}``."""
        name = rec.get("tenant")
        if not name:
            return
        lat = rec.get("latency")
        if isinstance(lat, dict):
            self.observe(f"tenant_p99_ms:{name}", lat.get("p99_ms"))
        self.observe(f"tenant_shed:{name}", rec.get("shed"))
        slo = rec.get("slo")
        if isinstance(slo, dict):
            w = slo.get("windows", {})
            self.observe(f"tenant_burn:{name}",
                         w.get("short", {}).get("burn_rate"))

    def ingest_prefetch(self, stats: dict) -> None:
        """Series points from a ``ColdPrefetcher.stats()``-shaped dict
        (prefer ``ColdPrefetcher.observe_into(hub)``, which feeds
        interval deltas instead of cumulative totals — including the
        ``cold_staged_rows_per_s`` curve the ``io_workers`` advisor
        reads, which needs an interval time base this path lacks)."""
        self.observe("prefetch_hit_rate", stats.get("hit_rate"))
        self.observe("prefetch_staged_rows", stats.get("staged_rows"))
        trunc = stats.get("truncated_rows")
        if trunc:
            self.observe("prefetch_truncated_rows", trunc)

    # -- reading -------------------------------------------------------------
    def counters(self) -> np.ndarray:
        with self._lock:
            self._fold_locked()
            out = self._counters.copy()
        self._drain_emits()
        return out

    def snapshot(self) -> dict:
        """One dict: per-series recent stats, counter totals + derived
        ratios, recent anomalies, latest advice."""
        with self._lock:
            self._fold_locked()
            series = {
                name: {**(s.window_stats(self.window) or {}),
                       "last": s.last(), "ewma": s.ewma(),
                       "n": s.total}
                for name, s in sorted(self.series.items())}
            out = {
                "steps": self._steps,
                "series": series,
                "counters": _metrics.counters_dict(self._counters),
                "derived": _metrics.derive(self._counters),
                "anomalies": list(self.anomalies),
                "advice": dict(self.advice),
            }
        self._drain_emits()
        return out

    # -- the advisory re-planner --------------------------------------------
    def replan(self, plan: Optional[PlanContext] = None) -> List[dict]:
        """Re-run the capacity planners against the OBSERVED
        distributions and return (and ``advice``-emit) one record per
        knob whose observed sizing disagrees with the plan. Advisory
        only — nothing is actuated.

        Record shape: ``{"key": <ADVICE_KEYS entry>, "current",
        "recommended", "observed": {...}, "reason"}``."""
        plan = plan or self.plan
        if plan is None:
            return []
        out = []
        # the whole advisory pass holds the hub lock: the advisors read
        # series windows (a concurrent append mid-read would hand them
        # a chronologically torn window) and write self.advice (which
        # snapshot() copies). Sink emission happens AFTER release —
        # slow disks must not stall the hub's other threads.
        with self._lock:
            self._fold_locked()
            for fn in (self._advise_hot_capacity,
                       self._advise_exchange_cap,
                       self._advise_dedup_budget, self._advise_batch_cap,
                       self._advise_max_wait, self._advise_io_workers,
                       self._advise_partitions,
                       self._advise_locality_weight):
                rec = fn(plan)
                if rec is not None:
                    out.append(rec)
                    self.advice[rec["key"]] = rec
        self._drain_emits()
        if self.sink is not None:
            for rec in out:
                self.sink.emit(rec, kind="advice")
        return out

    def _stats(self, name: str) -> Optional[dict]:
        s = self.series.get(name)
        if s is None or len(s) < self.window:
            return None
        return s.window_stats(self.window)

    def _advise_hot_capacity(self, plan: PlanContext) -> Optional[dict]:
        if plan.hot_capacity is None or plan.expected_hit_rate is None:
            return None
        obs = self._stats("hot_hit_rate")
        if obs is None:
            return None
        observed, target = obs["mean"], float(plan.expected_hit_rate)
        if observed >= target - 0.05:
            return None
        if plan.degree is not None:
            rec = rows_for_hit_rate(plan.degree, target)
        else:
            # no degree distribution: linear scaling is the
            # conservative inverse of any concave hit curve
            rec = int(math.ceil(plan.hot_capacity * target
                                / max(observed, 1e-6)))
        if plan.total_rows is not None:
            rec = min(rec, int(plan.total_rows))
        if rec <= plan.hot_capacity:
            return None
        return {
            "key": "hot_capacity",
            "current": int(plan.hot_capacity),
            "recommended": int(rec),
            "observed": {"hot_hit_rate": round(observed, 4),
                         "expected_hit_rate": round(target, 4)},
            "reason": (f"observed hot hit rate {observed:.2f} vs "
                       f"planned {target:.2f}; "
                       f"{rec} rows reach the planned rate under "
                       "degree-proportional access"),
        }

    def _advise_exchange_cap(self, plan: PlanContext) -> Optional[dict]:
        if plan.exchange_cap is None:
            return None
        peak = self._stats("exchange_bucket_max")
        if peak is None:
            return None
        from .comm import cap_for_expected_load
        cap = int(plan.exchange_cap)
        # the planner's OWN headroom formula, re-run on the observed
        # p95 per-owner load instead of the analytic degree-mass prior
        rec = cap_for_expected_load(peak["p95"], plan.slack)
        if plan.partition is not None and plan.frontier_cap is not None:
            dup = self._stats("dup_factor")
            if dup is not None and dup["mean"] >= 1.0:
                rec = max(rec, plan.partition.plan_exchange_cap(
                    int(plan.frontier_cap),
                    degree=plan.degree,
                    dup_factor=dup["mean"], slack=plan.slack).cap)
        headroom = 1.0 - peak["p95"] / cap if cap else 0.0
        fb = self._stats("exchange_fallback_rate")
        overflowing = fb is not None and fb["mean"] > 0
        if overflowing:
            # observed fallbacks mean the compact path's unique table /
            # buckets overflowed — and an overflowed (truncated) table
            # UNDERSTATES the observed peaks, so the peak-sized figure
            # is a floor, never a reason to shrink: grow by at least
            # one slack step above the current cap
            rec = max(rec, cap_for_expected_load(float(cap), plan.slack))
        if abs(rec - cap) <= 0.1 * cap and not overflowing:
            return None
        return {
            "key": "exchange_cap",
            "current": cap,
            "recommended": int(max(rec, 1)),
            "observed": {
                "bucket_peak_p95": round(peak["p95"], 1),
                "cap_headroom": round(headroom, 4),
                "fallback_rate": round(fb["mean"], 4) if fb else None},
            "reason": (f"observed cap headroom {headroom:.2f}, plan "
                       f"says {cap} -> advise {int(max(rec, 1))}"),
        }

    def _advise_dedup_budget(self, plan: PlanContext) -> Optional[dict]:
        if plan.dedup_budget is None:
            return None
        uniq = self._stats("dedup_unique_per_call")
        if uniq is None:
            return None
        from .comm import cap_for_expected_load
        budget = int(plan.dedup_budget)
        rec = cap_for_expected_load(uniq["p95"], plan.slack)
        ov = self._stats("dedup_overflow_rate")
        overflowing = ov is not None and ov["mean"] > 0
        if abs(rec - budget) <= 0.1 * budget and not overflowing:
            return None
        return {
            "key": "dedup_budget",
            "current": budget,
            "recommended": int(rec),
            "observed": {
                "unique_per_call_p95": round(uniq["p95"], 1),
                "overflow_rate": round(ov["mean"], 4) if ov else None},
            "reason": (f"observed p95 unique count {uniq['p95']:.0f} "
                       f"vs budget {budget}"
                       + (" (overflowing)" if overflowing else "")),
        }

    def _advise_batch_cap(self, plan: PlanContext) -> Optional[dict]:
        if plan.batch_cap is None:
            return None
        fill = self._stats("serve_batch_fill")
        if fill is None:
            return None
        cap = int(plan.batch_cap)
        if fill["p95"] >= 0.95 * cap:
            rec, why = 2 * cap, "batches saturate the cap"
        elif fill["p95"] < 0.25 * cap and cap > 8:
            rec = max(8, 1 << int(math.ceil(
                math.log2(max(2.0 * fill["p95"], 1.0)))))
            why = "batches run mostly empty (padded dispatch waste)"
        else:
            return None
        if rec == cap:
            return None
        return {
            "key": "batch_cap",
            "current": cap,
            "recommended": int(rec),
            "observed": {"batch_fill_p95": round(fill["p95"], 1)},
            "reason": f"p95 batch fill {fill['p95']:.0f}/{cap}: {why}",
        }

    def _advise_max_wait(self, plan: PlanContext) -> Optional[dict]:
        if plan.max_wait_ms is None or plan.target_p99_ms is None:
            return None
        p99 = self._stats("serve_request_p99_ms")
        if p99 is None:
            return None
        wait, target = float(plan.max_wait_ms), float(plan.target_p99_ms)
        fill = self._stats("serve_batch_fill")
        if p99["mean"] > target:
            rec, why = max(wait / 2, 0.25), (
                "requests miss the latency target; coalescing wait is "
                "the knob the server controls")
        elif (p99["mean"] < 0.5 * target and fill is not None
              and plan.batch_cap and fill["p95"] < 0.5 * plan.batch_cap):
            rec = min(2 * wait, target / 4)
            if rec <= wait:
                # the growth is already capped at/below the current
                # wait — a "grow" recommendation that shrinks would
                # carry the opposite of its rationale
                return None
            why = ("latency headroom + empty batches: longer "
                   "coalescing buys fill for free")
        else:
            return None
        if abs(rec - wait) < 1e-9:
            return None
        return {
            "key": "max_wait_ms",
            "current": wait,
            "recommended": round(rec, 3),
            "observed": {"request_p99_ms": round(p99["mean"], 2),
                         "target_p99_ms": target},
            "reason": why,
        }

    def _advise_io_workers(self, plan: PlanContext) -> Optional[dict]:
        """Size the cold tier's staging parallelism from the OBSERVED
        staged-rows/s curve (``ColdPrefetcher.observe_into`` feeds the
        ``cold_staged_rows_per_s`` series): when lookups still pay
        sync fallbacks (hit rate short of ~0.9) while the staging
        throughput has PLATEAUED (recent p95 within 15% of the window
        mean — more publications are not lifting the curve), the
        pipeline is IO-bound at its current width: advise doubling
        ``workers``, capped at the reader pool's ``io_qd`` (more
        stagers than device queue slots just queue behind each other).
        A rising curve or a healthy hit rate advises nothing — the
        current width is still delivering."""
        if plan.io_workers is None:
            return None
        hit = self._stats("prefetch_hit_rate")
        thr = self._stats("cold_staged_rows_per_s")
        if hit is None or thr is None or thr["mean"] <= 0:
            return None
        if hit["mean"] >= 0.9:
            return None
        plateau = thr["p95"] <= 1.15 * thr["mean"]
        if not plateau:
            return None
        cur = max(int(plan.io_workers), 1)
        cap = int(plan.io_qd) if plan.io_qd else 2 * cur
        rec = min(2 * cur, cap)
        if rec <= cur:
            return None
        return {
            "key": "io_workers",
            "current": cur,
            "recommended": int(rec),
            "observed": {
                "prefetch_hit_rate": round(hit["mean"], 4),
                "staged_rows_per_s_mean": round(thr["mean"], 1),
                "staged_rows_per_s_p95": round(thr["p95"], 1)},
            "reason": (f"hit rate {hit['mean']:.2f} with staging "
                       f"throughput flat at ~{thr['mean']:.0f} rows/s: "
                       f"IO-bound at {cur} worker(s); "
                       f"{rec} shards the unique-row set wider "
                       f"(<= io_qd={cap})"),
        }

    def _advise_partitions(self, plan: PlanContext) -> Optional[dict]:
        """Size the sharded-serving fleet from the same degree-mass
        inversion the hot-capacity advisor uses: the rows needed to
        reach the planned hit rate, divided by what ONE partition's hot
        tier holds, is how many partition homes the fleet needs so that
        locality routing CAN reach the target at all (no router blend
        fixes a fleet whose combined hot tiers don't cover the mass).
        Gated on the observed ``locality_hit_rate`` series actually
        falling short — a fleet already hitting the target is left
        alone."""
        if (plan.partitions is None or plan.hot_capacity is None
                or plan.expected_hit_rate is None
                or plan.degree is None):
            return None
        obs = self._stats("locality_hit_rate")
        if obs is None:
            return None
        observed, target = obs["mean"], float(plan.expected_hit_rate)
        if observed >= target - 0.05:
            return None
        need = rows_for_hit_rate(plan.degree, target)
        rec = max(1, int(math.ceil(need / max(int(plan.hot_capacity),
                                              1))))
        if rec <= int(plan.partitions):
            return None
        return {
            "key": "partitions",
            "current": int(plan.partitions),
            "recommended": int(rec),
            "observed": {"locality_hit_rate": round(observed, 4),
                         "expected_hit_rate": round(target, 4),
                         "rows_needed": int(need)},
            "reason": (f"observed locality hit rate {observed:.2f} vs "
                       f"planned {target:.2f}; {need} hot rows reach "
                       f"the target, needing {rec} partition hot "
                       f"tier(s) of {int(plan.hot_capacity)}"),
        }

    def _advise_locality_weight(self,
                                plan: PlanContext) -> Optional[dict]:
        """Tune the router's health/locality blend from the observed
        ``locality_hit_rate``: misses mean frontier rows ship through
        the exchange, so a short hit rate advises leaning HARDER on
        locality (up to 0.9 — health keeps its veto); a saturated one
        (>= 0.98) advises relaxing toward 0.5 so health can rebalance
        load again (pure locality pins the hottest partition's owner
        even while it sheds)."""
        if plan.locality_weight is None:
            return None
        obs = self._stats("locality_hit_rate")
        if obs is None:
            return None
        w = float(plan.locality_weight)
        observed = obs["mean"]
        target = float(plan.expected_hit_rate
                       if plan.expected_hit_rate is not None else 0.8)
        if observed < target - 0.05 and w < 0.9:
            rec = min(0.9, round(w + 0.25, 2))
            why = (f"locality hit rate {observed:.2f} short of "
                   f"{target:.2f}: mis-routed frontier rows pay the "
                   "exchange; lean harder on locality")
        elif observed >= 0.98 and w > 0.5:
            rec = max(0.5, round(w / 2, 2))
            why = (f"locality hit rate saturated at {observed:.2f}: "
                   "relax the blend so health can rebalance load")
        else:
            return None
        if abs(rec - w) < 1e-9:
            return None
        return {
            "key": "locality_weight",
            "current": w,
            "recommended": rec,
            "observed": {"locality_hit_rate": round(observed, 4),
                         "target": round(target, 4)},
            "reason": why,
        }

    # -- rendering -----------------------------------------------------------
    def report(self) -> str:
        """Human-readable hub section (also what the unified
        ``qt.metrics.report()`` renders once :meth:`install_report` has
        run)."""
        snap = self.snapshot()
        lines = [f"telemetry hub: {len(snap['series'])} series, "
                 f"{snap['steps']} steps observed"]
        for name, s in snap["series"].items():
            if s.get("n", 0) == 0:
                continue
            lines.append(
                f"  {name}: last {s['last']:.3f}  ewma {s['ewma']:.3f}  "
                f"p50 {s['p50']:.3f}  p95 {s['p95']:.3f}  (n={s['n']})")
        for a in list(snap["anomalies"])[-5:]:
            lines.append(
                f"  ANOMALY [{a['detector']}] {a['series']}: "
                f"{a['baseline']:.3f} -> {a['value']:.3f} "
                f"at step {a['step']}")
        for rec in snap["advice"].values():
            lines.append(
                f"  advice [{rec['key']}]: {rec['current']} -> "
                f"{rec['recommended']} ({rec['reason']})")
        return "\n".join(lines)

    def install_report(self, name: str = "telemetry") -> "TelemetryHub":
        """Register this hub's section into the unified
        ``metrics.report()``."""
        self._report_name = name
        _metrics.register_report_section(name, self.report)
        return self

    def uninstall_report(self) -> None:
        if self._report_name is not None:
            _metrics.unregister_report_section(self._report_name)
            self._report_name = None


class _Queued:
    """One queued counter vector: a host value, or a card tensor's copy
    in pinned memory with the event recorded after the copy."""

    __slots__ = ("value", "event")

    def __init__(self, value, event=None):
        self.value = value
        self.event = event

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def host(self):
        if self.event is not None:
            self.event.synchronize()
        return self.value


def _queue(counters) -> _Queued:
    """Start reading a counter vector without waiting for it: a tensor on
    the card is copied (``non_blocking``) into pinned host memory on its
    stream, and an event recorded after the copy tells when it landed."""
    if isinstance(counters, torch.Tensor) and counters.is_cuda:
        buf = torch.empty(counters.shape, dtype=counters.dtype,
                          pin_memory=True)
        buf.copy_(counters.detach(), non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(counters.device))
        return _Queued(buf, event)
    return _Queued(counters)


def _named_to_vec(d: dict) -> np.ndarray:
    vec = np.zeros((_metrics.NUM_COUNTERS,), np.int64)
    for slot, name in _metrics.SLOT_NAMES.items():
        v = d.get(name)
        if v is not None:
            vec[slot] = int(v)
    return vec


# -- the process-default hub -------------------------------------------------

_default_hub: Optional[TelemetryHub] = None
_default_lock = threading.Lock()


def hub(**kwargs) -> TelemetryHub:
    """The process-default :class:`TelemetryHub` (created on first use
    and auto-registered into the unified ``metrics.report()``).
    ``kwargs`` apply only on first creation."""
    global _default_hub
    with _default_lock:
        if _default_hub is None:
            _default_hub = TelemetryHub(**kwargs).install_report()
        return _default_hub


# -- the flight recorder -----------------------------------------------------


class FlightRecorder:
    """On crash or signal, dump ONE postmortem JSON: the last-N spans
    from the tracer ring, every hub series' tail, counter totals +
    derived ratios, recent anomalies, and the latest advice — the
    black box a dead run leaves behind.

    ``install()`` chains ``sys.excepthook`` (uncaught exceptions) and
    the given signals' previous handlers — the dump happens FIRST,
    then the prior behavior (handler, or the default action) proceeds,
    so installing never changes how the process dies. Explicit
    :meth:`dump` works without installing anything."""

    def __init__(self, path: str = "qt_postmortem.json",
                 hub: Optional[TelemetryHub] = None,
                 stats=None, max_spans: int = 256,
                 series_tail: int = 64):
        self.path = str(path)
        self.hub = hub
        self.stats = stats
        self.max_spans = int(max_spans)
        self.series_tail = int(series_tail)
        self._prev_hooks: Dict[int, object] = {}
        self._prev_excepthook: Optional[Callable] = None

    def dump(self, reason: str = "manual") -> str:
        """Write the postmortem; returns the path. Never raises — a
        crash handler that crashes loses the evidence."""
        import json
        doc: dict = {"reason": reason, "ts": round(time.time(), 3),
                     "pid": os.getpid()}
        try:
            from . import tracing
            recs = tracing.records()[-self.max_spans:]
            doc["spans"] = [
                {"name": n, "tid": tid, "t0": round(t0, 6),
                 "dur": round(dur, 6), "trace_id": trace_id,
                 "args": args, "span": sid, "parent": parent}
                for n, tid, t0, dur, trace_id, args, sid, parent, _ in recs]
        except Exception as e:
            doc["spans_error"] = repr(e)
        if self.hub is not None:
            try:
                # the dump may run INSIDE a signal handler, possibly
                # interrupting the very thread that holds the hub lock
                # — a blocking acquire would deadlock the handler and
                # swallow the signal. Best-effort: take the lock with a
                # timeout and read without it if the owner never
                # yields (a slightly torn series tail beats no
                # postmortem and a hung process).
                locked = self.hub._lock.acquire(timeout=1.0)
                try:
                    if locked:
                        self.hub._fold_locked()
                    else:
                        doc["hub_lock"] = "unavailable (lock-free read)"
                    doc["series"] = {
                        name: [round(float(v), 6)
                               for v in s.values()[-self.series_tail:]]
                        for name, s in sorted(self.hub.series.items())}
                    doc["counters"] = _metrics.counters_dict(
                        self.hub._counters)
                    doc["derived"] = _metrics.derive(self.hub._counters)
                    doc["anomalies"] = list(self.hub.anomalies)
                    doc["advice"] = dict(self.hub.advice)
                finally:
                    if locked:
                        self.hub._lock.release()
            except Exception as e:
                doc["hub_error"] = repr(e)
        if self.stats is not None:
            try:
                doc["step_stats"] = self.stats.snapshot()
            except Exception as e:
                doc["stats_error"] = repr(e)
        try:
            with open(self.path, "w") as f:
                json.dump(doc, f, default=_metrics._json_default)
        except Exception:
            return self.path
        return self.path

    # -- installation --------------------------------------------------------
    def install(self, signals: Sequence[int] = (_signal.SIGTERM,),
                excepthook: bool = True) -> "FlightRecorder":
        for sig in signals:
            prev = _signal.signal(sig, self._on_signal)
            self._prev_hooks[int(sig)] = prev
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_exception
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev_hooks.items():
            _signal.signal(sig, prev)
        self._prev_hooks = {}
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    def _on_signal(self, signum, frame) -> None:
        self.dump(reason=f"signal {_signal.Signals(signum).name}")
        prev = self._prev_hooks.get(int(signum))
        if callable(prev):
            prev(signum, frame)
        elif prev == _signal.SIG_DFL:
            # restore the default action and re-deliver: the dump must
            # not change whether the signal kills the process
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def _on_exception(self, exc_type, exc, tb) -> None:
        self.dump(reason=f"uncaught {exc_type.__name__}: {exc}")
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)
