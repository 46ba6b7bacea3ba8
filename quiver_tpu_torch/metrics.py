"""Runtime telemetry: device counters, step stats, JSONL sinks
(counterpart of ``quiver_tpu/metrics.py``).

**Device side.** A fixed-slot int32 counter vector (:class:`Collector`)
that the metered paths fill with tensor ops on values they already
compute: the tiered lookup's hot/cold classification mask
(``Feature._lookup_tiered``), the dedup unique count
(``ops/dedup.py``), the final frontier's valid slots
(``ops/sample_multihop.py`` and the fused walk of
``parallel/train.py``). Recording never reads a value back to the host,
so a metered step adds no host synchronisation, and it never feeds the
rows, logits, losses or gradients, which stay bit-identical with
metering on or off. The vector comes out of a step as one
``[NUM_COUNTERS]`` int32 tensor on the step's device.

**Host side.** :class:`StepStats` folds those vectors into an int64
total lazily (the vector of the step still in flight is never read), and
keeps a streaming latency histogram (p50/p95/p99).
:class:`MetricsSink` writes the JSONL record schema the JAX package
writes (``{"ts": ..., "kind": ..., ...}``), and :func:`read_jsonl` reads
either package's files: the slot numbers and names below are the JAX
package's, so a record from one reads the same in the other.

:meth:`StepStats.watch_pipeline` folds a staging ``Pipeline``'s queue
statistics into the snapshot, :func:`report` carries the tracer's line
(``tracing.py``), and ``MetricsSink.emit`` fires the ``"sink.write"``
fault site (``faults.py``), as in the JAX package.
:func:`pmerge_counters` merges a vector across the ranks of a
``torch.distributed`` process group (``comm.py``).
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import faults, tracing

# -- the device counter vector ---------------------------------------------
#
# One int32 vector per step, the slot layout of the JAX package. Per-step
# values are small (bounded by frontier capacities); long runs accumulate
# on the host in int64 (StepStats).

HOT_ROWS = 0          # valid tiered-lookup slots served from the hot tier
COLD_ROWS = 1         # valid tiered-lookup slots served from the cold tier
LOOKUP_CALLS = 2      # tiered lookups recorded
DEDUP_TOTAL = 3       # valid ids entering a dedup compaction
DEDUP_UNIQUE = 4      # true distinct count found (may exceed the budget)
DEDUP_OVERFLOW = 5    # dedup budget overflows (full-gather fallbacks)
EXCH_CALLS = 6        # cross-host exchange lookups
EXCH_FALLBACK = 7     # compact-exchange dense fallbacks taken
EXCH_BUCKET_MAX = 8   # peak per-owner request-bucket load       [max slot]
EXCH_CAP = 9          # the per-owner cap in force               [max slot]
FRONTIER_VALID = 10   # valid final-frontier slots out of sampling
FRONTIER_CAP = 11     # static final-frontier capacity
DEDUP_CALLS = 12      # dedup compactions recorded
PREFETCH_HIT_ROWS = 13    # disk-tier rows served from the staging ring
PREFETCH_SYNC_ROWS = 14   # disk-tier rows read synchronously (ring miss)
PREFETCH_STAGED_ROWS = 15  # rows the cold prefetcher staged into the ring
IO_EXTENTS = 16       # coalesced read requests the cold-IO path issued
IO_READ_ROWS = 17     # disk rows those extents covered
IO_READ_BYTES = 18    # bytes the storage device moved (saturates int32)
IO_DEPTH_PEAK = 19    # peak in-flight read requests observed [max slot]
IO_RETRIES = 20       # transient cold-IO read retries
FAULTS_INJECTED = 21  # faults an armed fault plan fired (process-wide)
STAGING_RESTARTS = 22  # staging workers auto-replaced / shards retried
LOCALITY_HIT_ROWS = 23   # frontier rows owned by the serving home partition
LOCALITY_MISS_ROWS = 24  # frontier rows owned elsewhere (exchange-remote)

NUM_COUNTERS = 25

#: slots merged with ``max`` across steps and shards; all others add
MAX_SLOTS = (EXCH_BUCKET_MAX, EXCH_CAP, IO_DEPTH_PEAK)

SLOT_NAMES = {
    HOT_ROWS: "hot_rows", COLD_ROWS: "cold_rows",
    LOOKUP_CALLS: "lookup_calls", DEDUP_TOTAL: "dedup_total",
    DEDUP_UNIQUE: "dedup_unique", DEDUP_OVERFLOW: "dedup_overflow",
    EXCH_CALLS: "exchange_calls", EXCH_FALLBACK: "exchange_fallback",
    EXCH_BUCKET_MAX: "exchange_bucket_max", EXCH_CAP: "exchange_cap",
    FRONTIER_VALID: "frontier_valid", FRONTIER_CAP: "frontier_cap",
    DEDUP_CALLS: "dedup_calls",
    PREFETCH_HIT_ROWS: "prefetch_hit_rows",
    PREFETCH_SYNC_ROWS: "prefetch_sync_rows",
    PREFETCH_STAGED_ROWS: "prefetch_staged_rows",
    IO_EXTENTS: "io_extents",
    IO_READ_ROWS: "io_read_rows",
    IO_READ_BYTES: "io_read_bytes",
    IO_DEPTH_PEAK: "io_depth_peak",
    IO_RETRIES: "io_retries",
    FAULTS_INJECTED: "faults_injected",
    STAGING_RESTARTS: "staging_worker_restarts",
    LOCALITY_HIT_ROWS: "locality_hit_rows",
    LOCALITY_MISS_ROWS: "locality_miss_rows",
}

_MAX_MASK_NP = np.zeros((NUM_COUNTERS,), bool)
_MAX_MASK_NP[list(MAX_SLOTS)] = True


class Collector:
    """Accumulator of one step's device counter vector.

    Create one per step, hand it down the metered path, and read the
    vector with :meth:`counters` as an extra output of the step. Values
    are Python ints or integer/bool tensors (0-d or one element) on the
    step's device; :meth:`counters` builds the ``[NUM_COUNTERS]`` int32
    tensor on their device (``device``, or the CPU, when every value is
    a Python int) with tensor ops only, so no value is read back to the
    host. Nothing recorded here may feed the step's results."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)
        self._entries: List[tuple] = []
        self._absorbed: List[torch.Tensor] = []

    def add(self, slot: int, value) -> None:
        """Accumulate ``value`` into an additive slot."""
        self._entries.append((int(slot), value, False))

    def peak(self, slot: int, value) -> None:
        """Merge ``value`` into a max slot."""
        self._entries.append((int(slot), value, True))

    def _where(self) -> torch.device:
        if self._device is not None:
            return self._device
        for _, v, _ in self._entries:
            if torch.is_tensor(v):
                return v.device
        for a in self._absorbed:
            return a.device
        return torch.device("cpu")

    def counters(self) -> torch.Tensor:
        """The ``[NUM_COUNTERS]`` int32 vector, on the values' device."""
        dev = self._where()
        vec = torch.zeros((NUM_COUNTERS,), dtype=torch.int32, device=dev)
        base = [0] * NUM_COUNTERS       # Python ints, added on the host
        peaks: Dict[int, int] = {}
        for slot, val, is_max in self._entries:
            if torch.is_tensor(val):
                v = val.reshape(1).to(device=dev, dtype=torch.int32)
                cell = vec.narrow(0, slot, 1)
                if is_max:
                    torch.maximum(cell, v, out=cell)
                else:
                    cell.add_(v)
            elif is_max:
                peaks[slot] = max(peaks.get(slot, int(val)), int(val))
            else:
                base[slot] += int(val)
        for slot, v in enumerate(base):
            if v:
                vec.narrow(0, slot, 1).add_(v)
        for slot, v in peaks.items():
            vec.narrow(0, slot, 1).clamp_(min=v)
        for a in self._absorbed:
            vec = merge_counters(vec, a.to(dev))
        return vec

    def absorb(self, vec) -> None:
        """Merge a counter vector (another collector's :meth:`counters`
        of the same step) into this one at :meth:`counters` time, with
        :func:`merge_counters`' slot semantics: how the serve step folds
        the store's own metered lookup into its vector."""
        self._absorbed.append(torch.as_tensor(vec).to(torch.int32))


_MASKS: Dict[torch.device, torch.Tensor] = {}


def _max_mask(dev: torch.device) -> torch.Tensor:
    """``MAX_SLOTS`` as a bool vector on ``dev``, made there once."""
    m = _MASKS.get(dev)
    if m is None:
        m = torch.zeros((NUM_COUNTERS,), dtype=torch.bool, device=dev)
        for s in MAX_SLOTS:
            m.narrow(0, s, 1).fill_(True)
        _MASKS[dev] = m
    return m


def merge_counters(a, b):
    """Merge two counter vectors (tensors on one device, or numpy):
    add, except ``MAX_SLOTS``, which take the max."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        a, b = np.asarray(a), np.asarray(b)
        return np.where(_MAX_MASK_NP, np.maximum(a, b), a + b)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dev = a.device if torch.is_tensor(a) else b.device
    return torch.where(_max_mask(dev), torch.maximum(a, b), a + b)


def pmerge_counters(vec, group=None):
    """The cross-rank merge of a counter vector on the device: every rank
    of ``group`` (the default group when None) calls it together and
    gets the one global vector, ``all_reduce(SUM)`` on additive slots and
    ``all_reduce(MAX)`` on ``MAX_SLOTS`` (the JAX package's ``psum`` and
    ``pmax`` over a mesh axis). Two collectives on an int32 vector: no
    host synchronisation, nothing read back."""
    import torch.distributed as dist
    vec = torch.as_tensor(vec).to(torch.int32)
    summed = vec.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    peaked = vec.clone()
    dist.all_reduce(peaked, op=dist.ReduceOp.MAX, group=group)
    return torch.where(_max_mask(vec.device), peaked, summed)


def merge_named_counters(a: Dict[str, int],
                         b: Dict[str, int]) -> Dict[str, int]:
    """Merge two named counter dicts (``counters_dict`` payloads, e.g.
    from per-host JSONL ``step_stats`` records) with the slot
    semantics: add, except the ``MAX_SLOTS`` names, which take the max.
    Unknown keys add."""
    max_names = {SLOT_NAMES[s] for s in MAX_SLOTS}
    out = dict(a)
    for k, v in b.items():
        if v is None:
            continue
        cur = out.get(k)
        if cur is None:
            out[k] = v
        else:
            out[k] = max(cur, v) if k in max_names else cur + v
    return out


def _host(c) -> np.ndarray:
    if torch.is_tensor(c):
        return c.detach().cpu().numpy()
    return np.asarray(c)


def reduce_counters(stack) -> np.ndarray:
    """Host fold of ``[..., NUM_COUNTERS]`` stacked vectors (tensors on
    any device, or numpy) into one int64 vector: sum over the leading
    axes, max on ``MAX_SLOTS``."""
    arr = _host(stack).astype(np.int64).reshape(-1, NUM_COUNTERS)
    summed = arr.sum(axis=0)
    peaked = arr.max(axis=0, initial=0)
    return np.where(_MAX_MASK_NP, peaked, summed)


def derive(counters) -> Dict[str, Optional[float]]:
    """Observed ratios from a counter vector: hot-tier hit rate,
    frontier duplicate factor, dedup and fallback rates, per-owner
    bucket headroom, frontier fill. ``None`` where the denominator never
    moved (the path was not exercised)."""
    c = _host(counters).astype(np.float64)
    if c.ndim > 1:
        c = reduce_counters(c).astype(np.float64)

    def ratio(num, den):
        return float(num / den) if den > 0 else None

    return {
        "hot_hit_rate": ratio(c[HOT_ROWS], c[HOT_ROWS] + c[COLD_ROWS]),
        "dup_factor": ratio(c[DEDUP_TOTAL], c[DEDUP_UNIQUE]),
        "dedup_overflow_rate": ratio(c[DEDUP_OVERFLOW], c[DEDUP_CALLS]),
        "exchange_fallback_rate": ratio(c[EXCH_FALLBACK], c[EXCH_CALLS]),
        "exchange_bucket_peak_frac": ratio(c[EXCH_BUCKET_MAX], c[EXCH_CAP]),
        "frontier_fill": ratio(c[FRONTIER_VALID], c[FRONTIER_CAP]),
        "prefetch_hit_rate": ratio(
            c[PREFETCH_HIT_ROWS],
            c[PREFETCH_HIT_ROWS] + c[PREFETCH_SYNC_ROWS]),
        "io_coalescing_factor": ratio(c[IO_READ_ROWS], c[IO_EXTENTS]),
        "locality_hit_rate": ratio(
            c[LOCALITY_HIT_ROWS],
            c[LOCALITY_HIT_ROWS] + c[LOCALITY_MISS_ROWS]),
    }


def counters_dict(counters) -> Dict[str, int]:
    """Named raw counters (host ints) for JSONL payloads."""
    c = reduce_counters(counters)
    return {name: int(c[slot]) for slot, name in SLOT_NAMES.items()}


# -- host-side aggregation --------------------------------------------------


class _Histogram:
    """Streaming log2-bucketed latency histogram: O(1) memory, one
    ``log2`` an add; quantiles from the cumulative bucket counts with
    linear interpolation inside the landing bucket."""

    _LO = 1e-6            # 1 us floor; anything faster lands in bucket 0

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def add(self, x: float) -> None:
        x = max(float(x), 0.0)
        self.n += 1
        self.total += x
        self.max = max(self.max, x)
        b = 0 if x < self._LO else int(math.log2(x / self._LO)) + 1
        self.counts[b] = self.counts.get(b, 0) + 1

    def quantile(self, q: float) -> float:
        if not self.n:
            return 0.0
        target = q * self.n
        seen = 0.0
        for b in sorted(self.counts):
            cnt = self.counts[b]
            if seen + cnt >= target:
                lo = 0.0 if b == 0 else self._LO * 2.0 ** (b - 1)
                hi = self._LO * 2.0 ** b
                frac = (target - seen) / cnt
                return min(lo + (hi - lo) * frac, self.max)
            seen += cnt
        return self.max


class StepStats:
    """Merges device counters with host-observed step facts.

    ``record_step(duration_s, counters=None)`` files one step: the
    latency lands in the streaming histogram; the counter vector (a
    tensor on the step's device, ``[N]`` or stacked ``[..., N]``) is
    queued and folded into an int64 total lazily (every ``fold_every``
    steps), never the vector just filed, so recording does not wait for
    the step in flight and long runs do not overflow int32.

    ``watch_compiles(*fns)`` counts executable-cache growth of callables
    with a ``_cache_size()``, as the JAX package does for its jitted
    steps; the port's steps run eagerly and have none, so they are
    skipped and no ``recompiles`` field appears.
    ``watch_pipeline(p)`` folds a ``pipeline.Pipeline``'s queue depth
    and wait statistics into the snapshot (its ``queue`` record)."""

    def __init__(self, fold_every: int = 64):
        self._fold_every = max(int(fold_every), 1)
        self._hist = _Histogram()
        self._req_hist = _Histogram()
        self._pending: List = []
        self._counters = np.zeros((NUM_COUNTERS,), np.int64)
        self._steps = 0
        self._compile_fns: List = []
        self._compile_base: Optional[int] = None
        self._pipelines: List = []
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def record_step(self, duration_s: float, counters=None) -> None:
        with self._lock:
            self._steps += 1
            self._hist.add(duration_s)
            if counters is not None:
                self._pending.append(counters)
                if len(self._pending) > self._fold_every:
                    self._fold_locked(keep=1)

    def request_p99_ms(self) -> Optional[float]:
        """The per-request p99 in ms (None before any request)."""
        with self._lock:
            if not self._req_hist.n:
                return None
            return 1e3 * self._req_hist.quantile(0.99)

    def record_request(self, duration_s: float) -> None:
        """File one per-request latency (admission to result), apart
        from the per-batch latency ``record_step`` files; snapshots gain
        a ``request`` block once one is recorded."""
        with self._lock:
            self._req_hist.add(duration_s)

    def add_counters(self, counters) -> None:
        """File a counter vector not tied to a timed step (e.g. a
        standalone metered lookup's)."""
        with self._lock:
            self._pending.append(counters)
            if len(self._pending) > self._fold_every:
                self._fold_locked(keep=1)

    def _fold_locked(self, keep: int = 0) -> None:
        # keep=1 on the recording path: the vector just filed belongs to
        # the step still in flight, and reading it would make the host
        # wait for that step
        if keep:
            pending = self._pending[:-keep]
            self._pending = self._pending[-keep:]
        else:
            pending, self._pending = self._pending, []
        for c in pending:
            vec = reduce_counters(c)
            self._counters = np.where(_MAX_MASK_NP,
                                      np.maximum(self._counters, vec),
                                      self._counters + vec)

    # -- watches ------------------------------------------------------------
    def watch_compiles(self, *fns) -> "StepStats":
        known = {id(f) for f in self._compile_fns}
        new = [f for f in fns
               if hasattr(f, "_cache_size") and id(f) not in known]
        if new:
            self._compile_base = ((self._compile_base or 0)
                                  + sum(f._cache_size() for f in new))
            self._compile_fns += new
        return self

    def _cache_total(self) -> int:
        return sum(f._cache_size() for f in self._compile_fns)

    def watch_pipeline(self, pipeline) -> "StepStats":
        self._pipelines.append(pipeline)
        return self

    # -- reading ------------------------------------------------------------
    def counters(self) -> np.ndarray:
        with self._lock:
            self._fold_locked()
            return self._counters.copy()

    def snapshot(self) -> dict:
        """One JSONL-ready record (kind ``step_stats``): step latency
        percentiles, the accumulated raw counters and their derived
        ratios, the recompile delta of watched callables, and the merged
        queue statistics of watched pipelines."""
        with self._lock:
            self._fold_locked()
            h = self._hist
            rec = {
                "steps": self._steps,
                "wall": {
                    "total_s": round(h.total, 6),
                    "mean_ms": round(1e3 * h.total / h.n, 3) if h.n else 0.0,
                    "p50_ms": round(1e3 * h.quantile(0.50), 3),
                    "p95_ms": round(1e3 * h.quantile(0.95), 3),
                    "p99_ms": round(1e3 * h.quantile(0.99), 3),
                    "max_ms": round(1e3 * h.max, 3),
                },
                "counters": counters_dict(self._counters),
                "derived": derive(self._counters),
            }
            r = self._req_hist
            if r.n:
                rec["request"] = {
                    "count": r.n,
                    "mean_ms": round(1e3 * r.total / r.n, 3),
                    "p50_ms": round(1e3 * r.quantile(0.50), 3),
                    "p95_ms": round(1e3 * r.quantile(0.95), 3),
                    "p99_ms": round(1e3 * r.quantile(0.99), 3),
                    "max_ms": round(1e3 * r.max, 3),
                }
        if self._compile_fns:
            rec["recompiles"] = self._cache_total() - self._compile_base
        if self._pipelines:
            # counts and wait totals add across pipelines; peaks and the
            # current depth take the max; the mean comes from the merged
            # totals (a sum of per-pipeline means would inflate it)
            merged: Dict[str, float] = {}
            for p in self._pipelines:
                for k, v in p.stats().items():
                    if k == "mean_wait_s":
                        continue
                    merged[k] = max(merged.get(k, 0), v) \
                        if (k.startswith("max_") or k == "depth") \
                        else merged.get(k, 0) + v
            done = merged.get("completed", 0) + merged.get("failed", 0)
            merged["mean_wait_s"] = (merged.get("total_wait_s", 0.0) / done
                                     if done else 0.0)
            rec["queue"] = merged
        return rec

    def report(self) -> str:
        """Human-readable rendering of :meth:`snapshot`."""
        s = self.snapshot()
        w, d, c = s["wall"], s["derived"], s["counters"]
        fmt = lambda v, pct=False: ("n/a" if v is None else
                                    f"{100.0 * v:.1f}%" if pct
                                    else f"{v:.2f}")
        lines = [
            f"steps: {s['steps']}  "
            f"(p50 {w['p50_ms']:.2f} ms, p95 {w['p95_ms']:.2f} ms, "
            f"p99 {w['p99_ms']:.2f} ms, mean {w['mean_ms']:.2f} ms)",
            f"hot-tier hit rate: {fmt(d['hot_hit_rate'], pct=True)}  "
            f"({c['hot_rows']} hot / {c['cold_rows']} cold rows)",
            f"frontier dup factor: {fmt(d['dup_factor'])}  "
            f"(dedup overflow rate {fmt(d['dedup_overflow_rate'], pct=True)})",
            f"exchange fallback rate: "
            f"{fmt(d['exchange_fallback_rate'], pct=True)}  "
            f"(peak bucket {c['exchange_bucket_max']}/{c['exchange_cap']}"
            f" = {fmt(d['exchange_bucket_peak_frac'], pct=True)} of cap)",
            f"frontier fill: {fmt(d['frontier_fill'], pct=True)}",
        ]
        if c["prefetch_hit_rows"] or c["prefetch_sync_rows"]:
            lines.append(
                f"cold-tier prefetch hit rate: "
                f"{fmt(d['prefetch_hit_rate'], pct=True)}  "
                f"({c['prefetch_staged_rows']} rows staged, "
                f"{c['prefetch_sync_rows']} sync fallbacks)")
        if c["io_extents"]:
            lines.append(
                f"cold-tier IO: {c['io_extents']} extents, "
                f"{fmt(d['io_coalescing_factor'])} rows/extent, "
                f"{c['io_read_bytes'] / 1e6:.1f} MB read, "
                f"depth peak {c['io_depth_peak']}")
        if "request" in s:
            r = s["request"]
            lines.insert(1, (
                f"per-request latency ({r['count']} requests): "
                f"p50 {r['p50_ms']:.2f} ms, p95 {r['p95_ms']:.2f} ms, "
                f"p99 {r['p99_ms']:.2f} ms, mean {r['mean_ms']:.2f} ms"))
        if "recompiles" in s:
            lines.append(f"recompiles since watch: {s['recompiles']}")
        if "queue" in s:
            q = s["queue"]
            lines.append("pipeline: " + ", ".join(
                f"{k}={round(v, 4)}" for k, v in sorted(q.items())))
        return "\n".join(lines)


# -- SLO error-budget accounting --------------------------------------------


class SloBudget:
    """Sliding-window SLO error-budget accounting with two-window burn
    rates.

    The SLO reads "over the window, at least ``availability`` of
    requests complete within ``target_p99_ms``". A request is bad when
    it fails or is shed (``ok=False``) or exceeds the target. The burn
    rate over a window is the bad fraction over the budget
    (``1 - availability``): 1.0 spends the budget exactly as fast as the
    SLO allows. :meth:`should_shed` is true while both the short window
    (``short_window_s``, above ``shed_burn_rate``) and the long one
    (``window_s``, above 1.0) burn too fast, each with at least
    ``min_requests`` samples. Bookkeeping is per-second buckets in a
    bounded deque, safe from any thread; :meth:`snapshot` is one
    JSONL-ready record (kind ``slo``)."""

    def __init__(self, target_p99_ms: float, availability: float = 0.99,
                 window_s: float = 300.0, short_window_s: float = 30.0,
                 shed_burn_rate: float = 1.0, min_requests: int = 20,
                 clock=None):
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {availability}")
        if not 0.0 < short_window_s <= window_s:
            raise ValueError("need 0 < short_window_s <= window_s")
        self.target_p99_ms = float(target_p99_ms)
        self.availability = float(availability)
        self.budget_frac = 1.0 - self.availability
        self.window_s = float(window_s)
        self.short_window_s = float(short_window_s)
        self.shed_burn_rate = float(shed_burn_rate)
        self.min_requests = int(min_requests)
        self._clock = clock if clock is not None else time.monotonic
        self._buckets: "collections.deque" = collections.deque()
        self._total = 0
        self._bad = 0
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def record(self, latency_s: Optional[float] = None,
               ok: bool = True) -> None:
        """File one request outcome: bad if it failed or was shed
        (``ok=False``) or exceeded the latency target."""
        bad = (not ok) or (latency_s is not None
                           and latency_s * 1e3 > self.target_p99_ms)
        sec = int(self._clock())
        with self._lock:
            b = self._buckets
            # a clock read that goes back lands in the newest bucket
            # rather than breaking the order the pruning relies on
            if b and b[-1][0] >= sec:
                slot = b[-1]
            else:
                slot = [sec, 0, 0]
                b.append(slot)
            slot[1] += 1
            slot[2] += int(bad)
            self._total += 1
            self._bad += int(bad)
            lo = self._clock() - self.window_s - 1.0
            while b and b[0][0] < lo:
                b.popleft()

    # -- reading ------------------------------------------------------------
    def _window_counts(self, seconds: float):
        lo = self._clock() - seconds
        total = bad = 0
        with self._lock:
            for sec, n, nb in reversed(self._buckets):
                if sec + 1.0 <= lo:      # bucket wholly before the window
                    break
                total += n
                bad += nb
        return total, bad

    def burn_rate(self, window_s: Optional[float] = None) -> Optional[float]:
        """Bad fraction over the window divided by the budget; ``None``
        below ``min_requests`` samples."""
        total, bad = self._window_counts(window_s or self.window_s)
        return self._rate(total, bad)

    def _rate(self, total, bad) -> Optional[float]:
        return ((bad / total) / self.budget_frac
                if total >= self.min_requests else None)

    def budget_remaining(self) -> Optional[float]:
        """Share of the long window's budget left: 1.0 untouched, 0.0
        spent, negative overspent; ``None`` below ``min_requests``."""
        total, bad = self._window_counts(self.window_s)
        if total < self.min_requests:
            return None
        return 1.0 - bad / (self.budget_frac * total)

    def should_shed(self) -> bool:
        """True while both windows burn the budget too fast."""
        s = self.burn_rate(self.short_window_s)
        if s is None or s <= self.shed_burn_rate:
            return False
        l = self.burn_rate(self.window_s)
        return l is not None and l > 1.0

    def snapshot(self) -> dict:
        """One JSONL-ready record (kind ``slo``), every field derived
        from one read of each window."""
        short_t, short_b = self._window_counts(self.short_window_s)
        long_t, long_b = self._window_counts(self.window_s)
        srate = self._rate(short_t, short_b)
        lrate = self._rate(long_t, long_b)
        remaining = (1.0 - long_b / (self.budget_frac * long_t)
                     if long_t >= self.min_requests else None)
        shedding = (srate is not None and srate > self.shed_burn_rate
                    and lrate is not None and lrate > 1.0)
        with self._lock:
            total, bad = self._total, self._bad
        return {
            "target_p99_ms": self.target_p99_ms,
            "availability": self.availability,
            "windows": {
                "short": {"window_s": self.short_window_s,
                          "requests": short_t, "bad": short_b,
                          "burn_rate": srate},
                "long": {"window_s": self.window_s,
                         "requests": long_t, "bad": long_b,
                         "burn_rate": lrate},
            },
            "budget_remaining": (None if remaining is None
                                 else round(remaining, 6)),
            "shedding": shedding,
            "total": {"requests": total, "bad": bad},
        }

    def emit(self, sink: "MetricsSink", kind: str = "slo") -> dict:
        """Append :meth:`snapshot` to a :class:`MetricsSink`."""
        return sink.emit(self.snapshot(), kind=kind)


# -- structured emission ----------------------------------------------------


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if torch.is_tensor(o):
        return o.detach().cpu().tolist()
    return str(o)


class MetricsSink:
    """Append-only JSONL emitter of the record schema the JAX package
    writes.

    ``path`` is a filesystem path (opened for append) or any file-like
    object with ``write``. Every record gains ``ts`` (unix seconds) and
    ``kind``. ``max_bytes`` (sinks that own their path) bounds the file:
    past it, the file rolls over to ``<path>.1`` and a fresh one starts;
    :func:`read_jsonl` reads across the seam. A sink that owns its path
    writes a ``meta`` record first (host, pid, start_ts, replica from
    the argument or ``QT_REPLICA``), and again after each rollover. A
    failed write is counted in ``write_errors`` and logged once, never
    raised: telemetry must not stop the path it observes."""

    def __init__(self, path, kind: str = "record",
                 max_bytes: Optional[int] = None,
                 replica: Optional[str] = None):
        self._own = isinstance(path, (str, bytes, os.PathLike))
        self._path = os.fspath(path) if self._own else None
        self._f = open(path, "a") if self._own else path
        self._kind = kind
        self._max_bytes = (int(max_bytes)
                           if max_bytes and self._own else None)
        self._replica = (str(replica) if replica
                         else os.environ.get("QT_REPLICA") or None)
        self._start_ts = time.time()
        self._meta_written = not self._own
        self.write_errors = 0
        self._warned_write = False
        self._lock = threading.Lock()

    def emit(self, record: dict, kind: Optional[str] = None) -> dict:
        rec = {"ts": round(time.time(), 3),
               "kind": kind or record.get("kind", self._kind)}
        rec.update({k: v for k, v in record.items() if k != "kind"})
        line = json.dumps(rec, default=_json_default)
        try:
            faults.fire("sink.write")    # the injectable disk failure
            with self._lock:
                if not self._meta_written:
                    self._meta_written = True
                    self._write_meta_locked()
                self._f.write(line + "\n")
                self._f.flush()
                if self._max_bytes and self._f.tell() >= self._max_bytes:
                    self._rollover_locked()
        except (OSError, ValueError) as e:
            with self._lock:
                self.write_errors += 1
                warn = not self._warned_write
                self._warned_write = True
            if warn:
                import logging
                logging.getLogger("quiver_tpu_torch.metrics").warning(
                    "MetricsSink write failed (%s): record dropped; "
                    "counted in write_errors (warning fires once)", e)
        return rec

    def _write_meta_locked(self, kind: str = "meta") -> None:
        import socket
        rec = {"ts": round(time.time(), 3), "kind": kind,
               "host": socket.gethostname(), "pid": os.getpid(),
               "start_ts": round(self._start_ts, 3)}
        if self._replica:
            rec["replica"] = self._replica
        self._f.write(json.dumps(rec, default=_json_default) + "\n")

    def _rollover_locked(self) -> None:
        # between emits only, so neither file holds a torn line
        self._f.close()
        os.replace(self._path, self._path + ".1")
        self._f = open(self._path, "a")
        self._write_meta_locked()

    def emit_stats(self, stats: StepStats, kind: str = "step_stats") -> dict:
        return self.emit(stats.snapshot(), kind=kind)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path) -> List[dict]:
    """A sink's records across the rollover seam: ``<path>.1`` (the
    older half, when present) then ``<path>``. Lines that do not parse
    (a crashed writer's torn last line) are skipped."""
    path = os.fspath(path)
    out: List[dict] = []
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    return out


# -- interactive convenience ------------------------------------------------

_default_stats: Optional[StepStats] = None
_default_lock = threading.Lock()

# report()'s extra sections: a component registers a zero-arg renderer
# under a name (the same name replaces) and unregisters when it closes
_report_sections: "collections.OrderedDict[str, object]" = \
    collections.OrderedDict()


def register_report_section(name: str, fn) -> None:
    """Register a zero-arg ``fn() -> str`` that :func:`report` renders
    after the default ``StepStats`` block. The same ``name`` replaces."""
    with _default_lock:
        _report_sections[name] = fn


def unregister_report_section(name: str) -> None:
    with _default_lock:
        _report_sections.pop(name, None)


def stats() -> StepStats:
    """The process-default :class:`StepStats` (made on first use)."""
    global _default_stats
    with _default_lock:
        if _default_stats is None:
            _default_stats = StepStats()
        return _default_stats


def report(obj=None) -> str:
    """A telemetry summary: of a :class:`StepStats`, or of a raw counter
    vector or stack. With no argument, the process-default stats, the
    tracer's status and every registered section (a section that raises
    renders its error in its place)."""
    if obj is not None:
        if isinstance(obj, StepStats):
            return obj.report()
        c = reduce_counters(obj)
        d = derive(c)
        named = counters_dict(c)
        parts = [f"{k}={v}" for k, v in named.items() if v]
        parts += [f"{k}={v:.3f}" for k, v in d.items() if v is not None]
        return "counters: " + (", ".join(parts) if parts else "(empty)")
    lines = [stats().report()]
    tr = tracing.get_tracer()
    lines.append(f"tracing: {'on' if tr.enabled else 'off'} "
                 f"({len(tr)}/{tr.capacity} spans retained)")
    with _default_lock:
        sections = list(_report_sections.items())
    for name, fn in sections:
        try:
            text = fn()
        except Exception as e:
            text = f"{name}: <report failed: {e!r}>"
        if text:
            lines.append(text)
    return "\n".join(lines)
