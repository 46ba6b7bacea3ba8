"""Leak check: repeated sample, lookup, train and serve cycles must not
grow the port's memory, threads or kernel set (the counterpart of the
JAX package's ``scripts/check_leak.py``, phase for phase).

Run::

    python -m quiver_tpu_torch.check_leak [--device cuda|cpu] [--quick]
                                          [--phase N ...]

``--device`` defaults to the card, as ``profile`` and ``analysis`` do;
``--quick`` cuts the cycle counts (never the widths); ``--phase`` picks
phases. The run prints one line per phase and exits nonzero at the first
phase that grew. ``chip_smoke.py`` calls :func:`run` in-process on the
card at its own full width (:class:`World`).

Each phase warms up, takes a base of every reading, runs its steady
loop, collects garbage, synchronises, and compares. The readings and
their bounds:

- live: on the card, ``torch.cuda.memory_stats()``'s
  ``active.all.current`` (live blocks); on the CPU, the count of live
  tensors (``gc.get_objects()``). At most +16, as JAX's live arrays,
  and under half the steady loop's units of work (``Probe.live_bound``;
  a served phase counts its batches): a block kept per unit, of any
  size, always exceeds it. A phase of one pass (10) keeps +16.
- bytes: on the card ``requested_bytes.all.current``, the bytes the
  live tensors asked for; on the CPU the bytes of the live tensors'
  storages. They return to the base within one cycle's output (the
  phase's ``out_bytes``): no JAX counterpart. Not
  ``allocated_bytes``: it counts whole cached blocks, and the allocator
  hands out a large block unsplit when at most 1 MB would be left, so
  a tensor reallocated at its old size can read up to 1 MB more (phase
  13's rotated hot tier: +424,960 bytes, live blocks and segments
  flat, late in the whole ``chip_smoke.py`` on an H100).
- segments: on the card the caching allocator's count of segments
  taken by ``cudaMalloc``, by pool (``segment.large_pool.allocated``,
  ``segment.small_pool.allocated``; ``segment.all.allocated`` is their
  sum). In torch a shape leak shows as new segments, not as recompiles.
  The large pool (blocks above 1 MB, the batch-shaped tensors) grows by
  0 in the steady loop. The small pool (2 MB segments of blocks up to 1
  MB) grows by at most 1: long-lived small blocks (a server's counter
  vectors waiting to be folded) pin fragments of its segments, so a
  scratch block near 1 MB (``torch.sort``'s in ``compact_layer`` at the
  shed rung's 107,520 keys) can take a new segment while the live
  blocks and bytes stay flat. That one segment cannot hide a leak per
  unit of work: each block kept per unit adds one to the live reading,
  whose bound is under the units. Each phase warms up until a pass of its
  own loop takes no new segment (``warm_up``). A block that allocates
  anew by design, phase 13's rotations (a new hot tier beside the old
  one an engine may still serve, as JAX's functional update), is
  measured apart (``Probe.reallocating``): the segments it takes are
  printed, not held, while its memory stays under the live and bytes
  bounds (a rotation that kept the old hot tier would grow the bytes
  by that tier, far past the bound). No reading on the CPU.
- libraries: ``ops.kernels._build.loaded_libraries._cache_size()``, the
  kernel libraries loaded, the port's counterpart of JAX's executable
  cache, which the recompile watches (``StepStats.watch_compiles``,
  ``TelemetryHub.watch_compiles``, a server's stats) read too. Growth 0.
- rss: the process's current resident set from ``/proc/self/statm``
  (pinned host memory counts in it), where JAX reads the peak
  ``ru_maxrss``. At most +256 MB. The disk tier maps its artifact's
  file, and the pages its reads touch stay resident up to the file's
  size; phases 8 and 11 touch every page of each mapping before the
  base (``touch_mapped``), since a kernel that does not tell file-backed
  pages apart (so on one H100 host) shows them as growth: +262 MB at
  one lookup of phase 8 without it, and +234 MB in phase 11 when the
  extent reader maps the file for its first failed read.
- launches: each kernel's launches per unit of work (a lookup, a step, a
  served batch) stay the same from unit to unit, read from the wrapper
  counters (``_build.LAUNCHES``) and the gathers' per-kernel totals
  (``_build.KERNEL_TOTALS``). A pipelined loop, whose worker thread
  launches while the consumer does, is held as a whole: its launches
  equal the units it ran times each unit's launches measured apart in
  the warm-up. The disk tier's ring gather launches once for a lookup
  that hits the ring and once more for each staging task the lookup
  waits for, so phases 8 and 11 bound it per lookup (at most 1 + the
  staging depth, 2) instead of holding it constant. On the CPU no
  kernel launches (every wrapper runs its plain version), so every
  count is 0.

The phases (JAX ``scripts/check_leak.py`` lines in brackets):

1. prefetch cycles: ``GraphSageSampler`` then ``Feature.prefetch`` over
   a store of the default placement (its host tier in plain host
   memory, as JAX's) [166-213];
2. pipelined ``dedup_cold`` lookups (``Feature._lookup_tiered``) beside
   train steps; torch updates the parameters and the Adam moments in
   place (JAX donates), and that is held: the same storages before and
   after [215-286];
3. the same over an int8 tier, its packed host rows read by
   ``gather_rows_packed_kernel`` on the card [288-323];
4. compact-exchange ``DistFeature`` lookups alternating duplicate-heavy
   (narrow) and unique-heavy (dense fallback) batches beside dist train
   steps, on 2 gloo ranks spawned by this module (on the card both
   share it); each rank reads its own readings and reports them to
   rank 0, and the phase fails if any rank grew. JAX runs 8 virtual
   hosts [325-446];
5. the metrics path: metered lookups and steps, ``StepStats``,
   ``MetricsSink`` [448-524];
6. point requests through ``MicroBatchServer`` across the shed ladder:
   the engine is held while the wave is submitted and a batch takes at
   most 16 requests, so the backlog crosses the shed threshold by
   construction [526-581];
7. traced and metered serving with a span ring smaller than the span
   volume, and the Chrome-trace export read back [583-631];
8. frontier-ahead disk-tier prefetch (``ColdPrefetcher``, 2 staging
   workers, a ring smaller than the cold rows the loop touches): the
   ring's buffers are the same allocations at the end, and no stager,
   reader or staging-pipeline thread survives ``close()`` [633-739];
9. ``TelemetryHub`` with its detectors armed, the re-planner live and
   series rings that wrap; the dedup-budget advisor fires [741-832];
10. a ``StageProfiler`` pass over the quick registry and the train
    pipeline, after a warm pass [834-883];
11. an active ``FaultPlan`` (storage errors, slow reads, a staging-worker
    death) over the disk tier and the server; the injections are
    counted, and the rows read after it equal those read before [885-986];
12. a ``TailSampler`` whose pending table is smaller than each burst
    (the engine is held while a burst is submitted, and a batch waits
    50 ms for company, so the first batch holds the whole burst); the
    pending high-water stays within its bound [988-1057];
13. ``Actuator`` knob swaps (one refused) and two hot-set rotations;
    every step's rows equal, bit for bit, those of an unactuated
    control store built apart from the same table [1059-1158];
14. ``ShardedServeEngine`` on phase 4's ranks, narrow and fallback
    batches alternating; each batch's logits equal an unsharded
    engine's on the same seeds bit for bit [1160-1257];
15. fused train and serve steps (``fused_multihop``), half the loop's
    cycles (five units each); each step's loss and the walk's frontier
    and rows equal the split replay through ``fused_multihop_reference``
    bit for bit, which on the card launches ``sample_layer_kernel``
    [1259-1383];
16. a replayed ``flash_crowd`` trace through a tenant-registry server
    with a depth-16 queue; the engine is held until the last arrival is
    offered, so the shed is certain by construction, and the per-tenant
    counters equal both the replay's records and a hand-fold of the
    trace [1385-1477].

On the card the bit-for-bit comparisons (phases 14, 15) run under
torch's deterministic algorithms, so the model's ``index_add_`` sums
run in one order.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

LIVE_SLACK = 16               # live tensors or blocks, as JAX's arrays
WARM = 4                      # cycles of a warm-up pass of a phase's loop
WARM_PASSES = 6               # warm-up passes at most (see warm_up)
RSS_SLACK_MB = 256.0          # host memory, as JAX's
RANKS = 2                     # phases 4 and 14 (JAX: 8 virtual hosts)
RANK_TIMEOUT = 300.0          # a rank's collectives and calls, s
STAGER_THREADS = ("qt-io-reader", "qt-stager", "quiver-cold-prefetch")


class LeakError(RuntimeError):
    """A phase grew a reading, or its premise did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise LeakError(msg)


# -- the world a run drives ---------------------------------------------------


@dataclass
class World:
    """What the phases run on: a CSR graph and its features, the model's
    widths, the walk, and the cycle counts. :func:`make_world` builds the
    JAX check's sizes; ``chip_smoke.py`` builds its full width.

    ``indptr``/``indices`` are int32 on ``device``, ``feat`` the fp32
    ``[n, dim]`` table on the CPU (the stores are built from it) and
    ``labels`` ``[n]`` int32 on ``device``. ``variants`` is the served
    engine's fanout ladder and ``serve_cap`` its batch; the served
    engine is the tiered path: an int8 store with a quarter of its rows
    hot on the device, the rest in (pinned) host memory, ``dedup_cold``
    on, served through the fused walk. ``lookup`` is the ids of one
    lookup batch and ``cold_budget`` the dedup stores' budget;
    ``dist_batch`` the ids each rank looks up in phase 4. ``cycles`` is
    each steady loop's length, ``requests`` phase 6's wave and
    ``bursts`` phase 12's."""

    device: torch.device
    indptr: torch.Tensor
    indices: torch.Tensor
    feat: torch.Tensor
    labels: torch.Tensor
    sizes: List[int]
    batch: int
    hidden: int
    classes: int
    variants: List[List[int]]
    serve_cap: int
    lookup: int
    cold_budget: int
    dist_batch: int
    cycles: int
    requests: int
    bursts: int
    seed: int = 0
    row_cap: int = 2048
    card: str = "cpu"
    rng: np.random.Generator = None
    _cache: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def dim(self) -> int:
        return int(self.feat.shape[1])

    def __post_init__(self):
        self.device = _device(self.device)   # the card by its index
        if self.rng is None:
            self.rng = np.random.default_rng(self.seed)

    def feat_device(self) -> torch.Tensor:
        """The fp32 table on the device (copied there once), which the
        steps and the walks read."""
        if "feat" not in self._cache:
            self._cache["feat"] = self.feat.to(self.device)
        return self._cache["feat"]

    def close(self) -> None:
        """Stop the rank pool and remove the disk artifact, if made."""
        pool = self._cache.pop("ranks", None)
        if pool is not None:
            pool.close()
        path = self._cache.pop("artifact", None)
        if path is not None:
            shutil.rmtree(path, ignore_errors=True)
        self._cache.clear()


def make_world(device="cuda", quick: bool = False, seed: int = 0) -> World:
    """The JAX check's sizes: 50,000 nodes of Poisson(12) degree, 64-wide
    fp32 features, fanout [10, 5] at batch 512, GraphSAGE 64 -> 32 -> 32
    -> 8, lookups of 2,048 ids against a dedup budget of 256, a served
    ladder [[10, 5], [4, 2], [2, 1]] at batch 64. ``quick`` cuts the
    steady loops to 20 cycles (JAX: 50 or 60) and the waves."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    n, dim = 50_000, 64
    deg = rng.poisson(12, n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    feat = rng.standard_normal((n, dim)).astype(np.float32)
    labels = rng.integers(0, 8, n).astype(np.int32)
    on = lambda a: torch.from_numpy(a).to(dev)
    return World(device=dev, indptr=on(indptr.astype(np.int32)),
                 indices=on(indices), feat=torch.from_numpy(feat),
                 labels=on(labels), sizes=[10, 5], batch=512, hidden=32,
                 classes=8, variants=[[10, 5], [4, 2], [2, 1]],
                 serve_cap=64, lookup=2048, cold_budget=256, dist_batch=256,
                 cycles=20 if quick else 50, requests=100 if quick else 200,
                 bursts=8 if quick else 20, seed=seed, row_cap=64,
                 card=card_line(dev), rng=rng)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    CPU: ``cpu``)."""
    if torch.device(dev).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# -- the readings -------------------------------------------------------------

CUDA_STATS = {"live": "active.all.current",
              "bytes": "requested_bytes.all.current",
              "segments": "segment.all.allocated",
              "large_segments": "segment.large_pool.allocated",
              "small_segments": "segment.small_pool.allocated"}
SMALL_SEGMENT_SLACK = 1       # the small pool's fragmentation (module doc)


def rss_mb() -> float:
    """The current resident set of this process in MB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def _cpu_tensors():
    """(live tensors, bytes of their distinct storages)."""
    seen, count, nbytes = set(), 0, 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): a deprecated torch object warns
            # when its __class__ is read
            if not issubclass(type(obj), torch.Tensor):
                continue
            count += 1
            if obj.is_meta or obj.layout != torch.strided:
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), st.nbytes())
        except Exception:
            continue
        if key not in seen:
            seen.add(key)
            nbytes += key[1]
    return count, nbytes


def readings(device) -> dict:
    """Every reading of the process now, after a garbage collection and,
    on the card, a synchronisation (module doc)."""
    from .ops.kernels import _build
    gc.collect()
    dev = torch.device(device)
    out = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        stats = torch.cuda.memory_stats(dev)
        for name, key in CUDA_STATS.items():
            if key not in stats:
                raise LeakError(f"torch.cuda.memory_stats() has no {key!r} "
                                f"(the {name} reading)")
            out[name] = int(stats[key])
    else:
        out["live"], out["bytes"] = _cpu_tensors()
        out["segments"] = out["large_segments"] = None
        out["small_segments"] = None
    out["libraries"] = _build.loaded_libraries._cache_size()
    out["rss_mb"] = rss_mb()
    return out


def segments(device) -> Optional[int]:
    """The allocator's segments taken by ``cudaMalloc`` so far (None on
    the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    key = CUDA_STATS["segments"]
    stats = torch.cuda.memory_stats(dev)
    if key not in stats:
        raise LeakError(f"torch.cuda.memory_stats() has no {key!r}")
    return int(stats[key])


def warm_up(device, one_pass, agree=None) -> int:
    """Run ``one_pass()`` (a pass of the phase's own loop) until a pass
    takes no new allocator segment, at most ``WARM_PASSES`` times, and
    return the passes run: the base is then taken at the allocator's
    plateau, and a segment the steady loop takes after it is growth. On
    the CPU one pass. ``agree(grew) -> bool`` makes ranks decide
    together (their collectives must run the same passes)."""
    passes = 0
    while True:
        before = segments(device)
        one_pass()
        passes += 1
        grew = before is not None and segments(device) != before
        if agree is not None:
            grew = agree(grew)
        if not grew or passes == WARM_PASSES:
            return passes


def launch_counts() -> Dict[str, int]:
    """The kernels' launches so far: the wrapper counts of the sampling
    kernels and each gather kernel's total (never reset)."""
    from .ops.kernels import _build
    with _build._launch_lock:
        out = {k: _build.LAUNCHES[k]
               for k in ("fused_sample_hop", "fused_hot_hop", "sample_layer")}
        out.update(_build.KERNEL_TOTALS)
        out["gather_rows"] = _build.LAUNCHES["gather_rows"]
        out["gather_elems"] = _build.LAUNCHES["gather_elems"]
        out["gather_rows_sharded"] = _build.LAUNCHES["gather_rows_sharded"]
    return out


def _delta(a: dict, b: dict) -> Dict[str, int]:
    return {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)
            if b.get(k, 0) != a.get(k, 0)}


def _sub(a: dict, n: int, unit: dict) -> dict:
    return {k: a.get(k, 0) - n * unit.get(k, 0) for k in set(a) | set(unit)}


# the wrapper names (chip_smoke's kernel entries)
WRAPPERS = ("fused_sample_hop", "fused_hot_hop", "sample_layer",
            "gather_rows", "gather_elems", "gather_rows_sharded")


class Probe:
    """One phase's readings: :meth:`base` after the warm-up, then units
    of work measured apart (:meth:`unit`), served batches
    (:meth:`served`) and pipelined windows (:meth:`window`), then
    :meth:`end`, which checks every bound and returns the record."""

    def __init__(self, number: int, name: str, device,
                 out_bytes: int = 0, vary: Optional[Dict[str, int]] = None):
        self.number, self.name = number, name
        self.device = torch.device(device)
        self.out_bytes = int(out_bytes)
        self.vary = dict(vary or {})
        self.units: Dict[str, List[dict]] = {}
        self.batches: Dict[str, List[tuple]] = {}
        self.windows: List[tuple] = []
        self.facts: dict = {}
        self.base_r = None
        self.base_l = None
        self.cycles = None
        self._served_mark: Dict[str, int] = {}
        self.excused = {"large_segments": 0, "small_segments": 0}

    # -- measuring --------------------------------------------------------
    @contextlib.contextmanager
    def unit(self, kind: str):
        """One unit of work of ``kind``: its launches are recorded."""
        before = launch_counts()
        yield
        self.units.setdefault(kind, []).append(_delta(before,
                                                      launch_counts()))

    @contextlib.contextmanager
    def served(self, server, kind: str = "served batch"):
        """A window of a server's traffic: its launches and batches."""
        before = launch_counts()
        b0 = server.snapshot()["serving"]["batches"]
        yield
        b1 = server.snapshot()["serving"]["batches"]
        self.batches.setdefault(kind, []).append(
            (b1 - b0, _delta(before, launch_counts())))

    @contextlib.contextmanager
    def reallocating(self):
        """A block that allocates anew by design (a rotation's new hot
        tier, kept apart from the old one an engine may still serve):
        the segments it takes are recorded and not held against the
        loop; its memory is, through the live and bytes readings."""
        before = readings(self.device) if self.device.type == "cuda" \
            else None
        yield
        if before is not None:
            after = readings(self.device)
            for k in self.excused:
                self.excused[k] += after[k] - before[k]

    def base(self, cycles: Optional[int] = None) -> None:
        """Take the base readings. ``cycles`` is the count of units of
        work the steady loop runs next; None counts the served batches
        of the windows after the base (a phase of one pass has none)."""
        self.base_r = readings(self.device)
        self.base_l = launch_counts()
        self.cycles = cycles
        self._served_mark = {k: len(v) for k, v in self.batches.items()}

    def live_bound(self) -> int:
        """The live reading's bound: JAX's +16, and under half the
        steady loop's units, so that a block kept per unit always
        exceeds it (a single pass keeps +16)."""
        units = self.cycles
        if units is None:
            units = sum(n for k, recs in self.batches.items()
                        for n, _ in recs[self._served_mark.get(k, 0):])
        return LIVE_SLACK if units < 2 else min(LIVE_SLACK, units // 2)

    def window(self, units: Dict[str, int]) -> None:
        """Hold the launches since :meth:`base` to ``units`` (kind ->
        count) of the units measured apart."""
        self.windows.append((dict(units),
                             _delta(self.base_l, launch_counts())))

    # -- judging ----------------------------------------------------------
    def _unit_vector(self, kind: str) -> dict:
        if kind in self.units:
            return self.units[kind][0]
        n, d = self.batches[kind][0]
        return {k: v // max(n, 1) for k, v in d.items()}

    def _check_launches(self) -> List[str]:
        bad = []
        for kind, deltas in self.units.items():
            first = deltas[0]
            for i, d in enumerate(deltas):
                for k in set(d) | set(first):
                    if k in self.vary:
                        if not 0 <= d.get(k, 0) <= self.vary[k]:
                            bad.append(f"{kind} {i}: {k} launched "
                                       f"{d.get(k, 0)} times, bound "
                                       f"{self.vary[k]}")
                    elif d.get(k, 0) != first.get(k, 0):
                        bad.append(f"{kind} {i}: {k} launched "
                                   f"{d.get(k, 0)} times, unit 0 "
                                   f"{first.get(k, 0)}")
        for kind, recs in self.batches.items():
            n0, d0 = recs[0]
            for i, (n, d) in enumerate(recs):
                for k in set(d) | set(d0):
                    if d.get(k, 0) * max(n0, 1) != d0.get(k, 0) * max(n, 1) \
                            or (n and d.get(k, 0) % n):
                        bad.append(f"{kind} window {i}: {k} launched "
                                   f"{d.get(k, 0)} times over {n} batches, "
                                   f"window 0 {d0.get(k, 0)} over {n0}")
        for units, d in self.windows:
            rest = dict(d)
            slack = {}
            for kind, count in units.items():
                rest = _sub(rest, count, self._unit_vector(kind))
                for k in self.vary:
                    slack[k] = slack.get(k, 0) + count * self.vary[k]
            for k, v in rest.items():
                if k in self.vary:
                    if not -slack[k] <= v <= slack[k]:
                        bad.append(f"window {units}: {k} off by {v}, "
                                   f"bound {slack[k]}")
                elif v:
                    bad.append(f"window {units}: {k} launched {v} times "
                               "more than its units")
        return bad

    def per_cycle(self) -> Dict[str, Dict[str, float]]:
        """Each kind's launches per unit by wrapper name."""
        out = {}
        for kind in list(self.units) + list(self.batches):
            v = self._unit_vector(kind)
            if kind in self.batches and kind not in self.units:
                n, d = self.batches[kind][0]
                v = {k: x / max(n, 1) for k, x in d.items()}
            out[kind] = {k: v[k] for k in WRAPPERS if v.get(k)}
        return out

    def end(self, **facts) -> dict:
        """Take the end readings and check every bound; the record."""
        self.facts.update(facts)
        r1 = readings(self.device)
        r0 = self.base_r
        bad = []
        live_bound = self.live_bound()
        if r1["live"] > r0["live"] + live_bound:
            bad.append(f"live {r0['live']} -> {r1['live']} (bound +"
                       f"{live_bound})")
        if r1["bytes"] > r0["bytes"] + self.out_bytes:
            bad.append(f"bytes {r0['bytes']} -> {r1['bytes']} (bound +"
                       f"{self.out_bytes}, one cycle's output)")
        ex = self.excused
        if r0["segments"] is not None and (
                r1["large_segments"] - ex["large_segments"]
                > r0["large_segments"]
                or r1["small_segments"] - ex["small_segments"]
                > r0["small_segments"] + SMALL_SEGMENT_SLACK):
            bad.append(f"segments {r0['segments']} -> {r1['segments']}, "
                       f"large pool {r0['large_segments']} -> "
                       f"{r1['large_segments']} (bound +0), small pool "
                       f"{r0['small_segments']} -> {r1['small_segments']} "
                       f"(bound +{SMALL_SEGMENT_SLACK}); "
                       f"taken by reallocations by design {ex}")
        if r1["libraries"] != r0["libraries"]:
            bad.append(f"kernel libraries {r0['libraries']} -> "
                       f"{r1['libraries']} (bound +0)")
        if r1["rss_mb"] > r0["rss_mb"] + RSS_SLACK_MB:
            bad.append(f"rss {r0['rss_mb']:.0f} -> {r1['rss_mb']:.0f} MB "
                       f"(bound +{RSS_SLACK_MB:.0f})")
        bad += self._check_launches()
        rec = {"phase": self.number, "name": self.name, "base": r0,
               "end": r1, "launches_per_cycle": self.per_cycle(),
               "out_bytes": self.out_bytes, "live_bound": live_bound,
               **self.facts}
        if any(ex.values()):
            rec["reallocation_segments"] = dict(ex)
        if bad:
            raise LeakError(f"phase {self.number} ({self.name}) grew: "
                            + "; ".join(bad) + f" [{json.dumps(rec)}]")
        return rec


def nbytes(t) -> int:
    from .ops import quant
    if quant.is_quantized(t):
        return sum(nbytes(x) for x in quant.tier_parts(t) if x is not None)
    return int(t.numel() * t.element_size())


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def deterministic(dev):
    """torch's deterministic algorithms on the card for a block, so the
    model's ``index_add_`` sums run in one order (the CPU's already do)."""
    if torch.device(dev).type != "cuda":
        yield
        return
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def thread_names() -> List[str]:
    return sorted(t.name for t in threading.enumerate())


# -- shared makers -----------------------------------------------------------


def topo_of(w: World):
    from .utils import CSRTopo
    return CSRTopo(indptr=w.indptr, indices=w.indices, device=w.device)


def check_placed(store, table: torch.Tensor) -> None:
    """The store's hot tier holds, bit for bit, the host's own encoding
    of the table's hot rows (``table`` is the fp32 table on the CPU the
    store was built from): a copy to the card that lands other bytes
    fails here."""
    from .ops import quant
    if store.device_part is None:
        return
    rows = store.cache_rows
    if store.feature_order is None:
        hot = table[:rows]
    else:
        order = store.feature_order.cpu().long()
        node = torch.empty_like(order)
        node[order] = torch.arange(order.numel())
        hot = table[node[:rows]]
    want = quant.quantize(hot, store.dtype_policy["hot"])
    for got, ref in zip(quant.tier_parts(store.device_part),
                        quant.tier_parts(want)):
        check((got is None) == (ref is None),
              "the placed hot tier has other parts than the host's")
        if got is None:
            continue
        got = got.cpu().contiguous()
        ref = ref.contiguous()
        same = (got.reshape(rows, -1).view(torch.uint8)
                == ref.reshape(rows, -1).view(torch.uint8)).all(1)
        if not bool(same.all()):
            raise LeakError(
                f"the hot tier placed on {store.device} differs from the "
                f"host's rows: {int((~same).sum())} of {rows} rows, the "
                f"first at storage row {int((~same).nonzero()[0, 0])}")


def fp32_store(w: World, **kw):
    """A store over the world's table with a quarter of its rows hot
    (fp32), built from the table on the host and checked as placed."""
    from . import Feature
    store = Feature(device_cache_size=w.n // 4 * w.dim * 4,
                    csr_topo=topo_of(w), device=w.device,
                    **kw).from_cpu_tensor(w.feat)
    check_placed(store, w.feat)
    return store


def int8_store(w: World, **kw):
    """A store over the world's table stored int8, a quarter of its rows
    hot, built from the table on the host and checked as placed."""
    from . import Feature
    from .ops import quant
    store = Feature(
        device_cache_size=w.n // 4 * quant.row_bytes(w.dim, "int8"),
        csr_topo=topo_of(w), dtype_policy="int8", device=w.device,
        **kw).from_cpu_tensor(w.feat)
    check_placed(store, w.feat)
    return store


def dup_batches(rng: np.random.Generator, n: int, count: int, size: int,
                device):
    """``count`` duplicate-heavy id batches (each drawn from a pool of a
    quarter of its size), as JAX's ``dup_batches``."""
    for _ in range(count):
        pool = rng.integers(0, n, size // 4)
        ids = pool[rng.integers(0, pool.size, size)].astype(np.int32)
        yield torch.from_numpy(ids).to(device)


def train_seeds(w: World, rng: np.random.Generator, bs: int) -> torch.Tensor:
    """``bs`` distinct valid seeds (the train step's batch contract)."""
    return torch.from_numpy(rng.choice(w.n, bs, replace=False)
                            .astype(np.int32)).to(w.device)


def new_model(w: World, dropout: float = 0.0, seed: int = 1):
    from .models import GraphSAGE
    torch.manual_seed(seed)
    return GraphSAGE(w.dim, w.hidden, w.classes, len(w.sizes),
                     dropout=dropout).to(w.device)


def trainer(w: World, collect_metrics: bool = False, seed: int = 1,
            **kw):
    """(state, step, draw) for GraphSAGE on ``w`` with Adam 1e-3:
    ``draw()`` gives the next step's ``(hop_seeds, dropout_seed)``."""
    from .parallel import build_train_step, init_state
    from .parallel.train import draw_step_seeds
    model = new_model(w, seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = build_train_step(model, opt, w.sizes, w.batch,
                            collect_metrics=collect_metrics, **kw)
    gen = torch.Generator().manual_seed(w.seed + seed)
    return init_state(model, opt), step, \
        (lambda: draw_step_seeds(gen, len(w.sizes)))


def train_storages(state) -> List[int]:
    """The storages of the parameters and the Adam moments, in order."""
    ptrs = [p.data_ptr() for p in state.model.parameters()]
    for st in state.optimizer.state.values():
        ptrs += [v.data_ptr() for v in st.values()
                 if torch.is_tensor(v) and v.dim() > 0]
    return ptrs


def engine_of(w: World, collect_metrics: bool = True):
    """The served path: ``ServeEngine(fused_hot_hop=True)`` over the int8
    tiered store (``World``), its kernels built by ``warmup``."""
    key = ("engine", collect_metrics)
    if key not in w._cache:
        from . import ServeEngine
        store = int8_store(w, dedup_cold=True, host_placement="offload")
        model = new_model(w, seed=3)
        w._cache[key] = ServeEngine(
            model, None, (w.indptr, w.indices), store, w.variants,
            w.serve_cap, fused_hot_hop=True, fused_row_cap=w.row_cap,
            collect_metrics=collect_metrics, seed=w.seed,
            device=w.device).warmup()
    return w._cache[key]


class Gate:
    """An engine whose ``run`` waits while the gate is shut: the server
    then cannot drain while a wave is submitted, so a backlog, or a
    shed, is certain by construction. Every other attribute is the
    engine's."""

    def __init__(self, engine, timeout: float = 120.0):
        self._engine = engine
        self._open = threading.Event()
        self._open.set()
        self._timeout = timeout

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def shut(self) -> None:
        self._open.clear()

    def open(self) -> None:
        self._open.set()

    def run(self, *args, **kwargs):
        if not self._open.wait(self._timeout):
            raise LeakError("the gate stayed shut: the wave never ended")
        return self._engine.run(*args, **kwargs)


def served_stats():
    """A server's ``StepStats`` watching the loaded kernel libraries (the
    port's recompile watch). It folds every 8 batches, so at most 9 of
    the batches' counter vectors wait unfolded (the default, 64, would
    let them pass the live bound)."""
    from . import metrics
    from .ops.kernels import _build
    return metrics.StepStats(fold_every=8).watch_compiles(
        _build.loaded_libraries)


def wait_all(futs, timeout: float = 120.0) -> List[np.ndarray]:
    out = [f.result(timeout=timeout) for f in futs]
    check(all(np.isfinite(r).all() for r in out), "non-finite served rows")
    return out


def logits_bytes(w: World) -> int:
    return w.serve_cap * w.classes * 4


# -- phase 1: prefetch cycles -------------------------------------------------


def phase_prefetch(w: World) -> dict:
    from . import GraphSageSampler
    dev, rng = w.device, w.rng
    sampler = GraphSageSampler(topo_of(w), w.sizes, device=dev)
    store = fp32_store(w)
    state = {}

    def cycle():
        seeds = torch.from_numpy(rng.integers(0, w.n, w.batch)
                                 .astype(np.int32)).to(dev)
        n_id, _, _ = sampler.sample(seeds)
        x = store.prefetch(n_id).result()
        _sync(dev)
        state["out"] = nbytes(x)

    try:
        passes = warm_up(dev, lambda: [cycle() for _ in range(WARM)])
        probe = Probe(1, "prefetch cycles", dev, out_bytes=state["out"])
        probe.base(cycles=w.cycles)
        for _ in range(w.cycles):
            with probe.unit("sample + prefetch"):
                cycle()
    finally:
        store.close()
    return probe.end(cycles=w.cycles, warm_passes=passes)


# -- phases 2 and 3: pipelined dedup lookups (+ train steps) ------------------


def _pipelined_lookups(w: World, number: int, name: str, store,
                       steps: bool) -> dict:
    from .pipeline import pipelined
    dev, rng = w.device, w.rng
    host = store._host_offload

    def lookup(ids):
        out = store._lookup_tiered(store.device_part, host, ids,
                                   store.feature_order)
        _sync(dev)
        return out

    if steps:
        state, step, draw = trainer(w)
        feat = w.feat_device()

        def one_step(state):
            seeds = train_seeds(w, rng, w.batch)
            hs, drop = draw()
            return step(state, feat, None, w.indptr, w.indices, seeds,
                        w.labels[seeds.long()], hs, drop)

    def loop(count, state):
        out = loss = None
        for out in pipelined(lookup, dup_batches(rng, w.n, count, w.lookup,
                                                 dev)):
            if steps:
                state, loss = one_step(state)
        del out
        _sync(dev)
        return state, loss

    # the warm-up runs the loop itself: lookups on the worker beside
    # steps on this thread reach a peak that neither reaches alone
    box = {"state": state if steps else None}

    def warm():
        box["state"], _ = loop(WARM, box["state"])

    passes = warm_up(dev, warm)
    state = box["state"]
    probe = Probe(number, name, dev, out_bytes=w.lookup * w.dim * 4)
    with probe.unit("lookup"):
        lookup(next(dup_batches(rng, w.n, 1, w.lookup, dev)))
    if steps:
        with probe.unit("train step"):
            state, _ = one_step(state)
            _sync(dev)
        storages = train_storages(state)
    probe.base(cycles=w.cycles)
    state, loss = loop(w.cycles, state)
    probe.window({"lookup": w.cycles, **({"train step": w.cycles}
                                         if steps else {})})
    facts = {"lookups": w.cycles, "warm_passes": passes}
    if steps:
        check(bool(torch.isfinite(loss)), "non-finite loss")
        check(train_storages(state) == storages,
              "a train step reallocated the parameters or the Adam moments "
              "(the update must be in place)")
        facts.update(steps=w.cycles, in_place=True)
    store.close()
    return probe.end(**facts)


def phase_dedup(w: World) -> dict:
    store = fp32_store(w, dedup_cold=True, cold_budget=w.cold_budget,
                       host_placement="offload")
    return _pipelined_lookups(w, 2, "pipelined dedup lookups + train steps",
                              store, steps=True)


def phase_int8(w: World) -> dict:
    store = int8_store(w, dedup_cold=True, cold_budget=w.cold_budget,
                       host_placement="offload")
    return _pipelined_lookups(w, 3, "pipelined int8-tier lookups", store,
                              steps=False)


# -- the ranks of phases 4 and 14 ---------------------------------------------


def _rank_main(rank, world_size, init_method, device, tasks, results):
    """A rank's loop: join the gloo group (and a second group over the
    same ranks, so that a pipeline worker's lookups and the consumer's
    steps never share one), run calls until told to stop (None)."""
    import torch.distributed as tdist
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores with each other
            torch.set_num_threads(max(1, torch.get_num_threads()
                                      // world_size))
        from .comm import init_distributed
        world = init_distributed("gloo", init_method, world_size, rank,
                                 RANK_TIMEOUT)
        groups = {"lookup": world,
                  "step": tdist.new_group(list(range(world_size)))}
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(rank, world_size, groups, *args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    tdist.destroy_process_group()


class Ranks:
    """``world_size`` spawned gloo ranks (on the card all of them share
    it), each call bounded by ``timeout`` seconds; :meth:`close` joins
    every process (ending one that does not stop)."""

    def __init__(self, world_size: int, device, timeout: float = RANK_TIMEOUT):
        import torch.multiprocessing as mp
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self._dir = tempfile.mkdtemp(prefix="qt_leak_ranks_")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        self._results = ctx.Queue()
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, self.world_size, init,
                                         str(device), self._tasks[r],
                                         self._results), daemon=True)
                       for r in range(self.world_size)]
        self._closed = False
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        out, errors = [None] * self.world_size, []
        try:
            for _ in range(self.world_size):
                rank, ok, val = self._results.get(timeout=self.timeout)
                if ok:
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
        except queue.Empty:
            errors.append(f"no result within {self.timeout:g} s")
        if errors:
            self.close()
            raise LeakError(f"ranks: {what} failed:\n" + "\n".join(errors))
        return out

    def run(self, fn, *args) -> list:
        """``fn(rank, world_size, groups, *args)`` on every rank."""
        check(not self._closed, "the ranks are closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(fn.__name__)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)


def ranks_of(w: World) -> Ranks:
    if "ranks" not in w._cache:
        w._cache["ranks"] = Ranks(RANKS, w.device)
    return w._cache["ranks"]


def _any(flag: bool, groups) -> bool:
    """``flag`` on any rank (an all-reduce over the steps' group)."""
    import torch.distributed as tdist
    t = torch.tensor([int(flag)])
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=groups["step"])
    return bool(t.item())


def _gathered(rank, groups, rec_or_error) -> Optional[list]:
    """Every rank's record (or error text) on rank 0."""
    import torch.distributed as tdist
    recs = [None] * tdist.get_world_size(groups["step"])
    tdist.all_gather_object(recs, rec_or_error, group=groups["step"])
    return recs if rank == 0 else None


def _rank_probe(rank, groups, body):
    """``body()`` -> this rank's record, or its error; all gathered."""
    try:
        rec = body()
    except Exception:
        rec = {"error": traceback.format_exc()}
    return _gathered(rank, groups, rec)


def _ranks_record(number: int, name: str, per_rank: list) -> dict:
    recs = per_rank[0]
    bad = [f"rank {r}: {rec['error']}" for r, rec in enumerate(recs)
           if "error" in rec]
    if bad:
        raise LeakError(f"phase {number} ({name}): " + "\n".join(bad))
    out = dict(recs[0])
    out["ranks"] = recs
    return out


# -- phase 4: compact-exchange dist lookups + dist steps ----------------------


def _dist_rank(rank, world_size, groups, spec):
    spec = _on_device(spec)

    def body():
        from . import DistFeature, PartitionInfo, TorchComm
        from .ops.dedup import compact_exchange_slots
        from .parallel import build_dist_train_step, init_state
        from .parallel.dist import rank_step_seeds
        from .pipeline import pipelined
        dev = torch.device(spec["device"])
        rng = np.random.default_rng(spec["seed"] + 101 * (rank + 1))
        n, cap, size = spec["n"], spec["cap"], spec["dist_batch"]
        g2h = spec["g2h"]
        info = PartitionInfo(host=rank, hosts=world_size, global2host=g2h)
        dist = DistFeature.from_partition(
            spec["feat"], info, TorchComm(rank, world_size,
                                          group=groups["lookup"]),
            exchange_cap=cap, device=dev)

        def make_batch(i):
            if i % 2 == 0:
                pool = rng.integers(0, n, 16)
                ids = pool[rng.integers(0, pool.size, size)]
            else:
                ids = rng.integers(0, n, size)
            return ids.astype(np.int32)

        narrow = compact_exchange_slots(make_batch(0), cap, world_size,
                                        owner=g2h) == cap * world_size
        fallback = compact_exchange_slots(make_batch(1), cap, world_size,
                                          owner=g2h) == size
        check(narrow and fallback, "phase premise: an even batch must fit "
              "the narrow exchange and an odd one trip the fallback")

        def lookup(ids):
            out = dist[ids]
            _sync(dev)
            return out

        def batches(count):
            for i in range(count):
                yield torch.from_numpy(make_batch(i)).to(dev)

        model = new_model(_SpecWorld(spec), seed=1)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        per_host = spec["batch"] // world_size
        sizes = spec["sizes"]
        step = build_dist_train_step(model, opt, sizes, per_host,
                                     groups["step"], dist._rows_per_host,
                                     exchange_cap=cap)
        state = init_state(model, opt)
        labels = spec["labels"]

        def one_step(state, it):
            seeds = torch.from_numpy(rng.choice(n, per_host, replace=False)
                                     .astype(np.int32)).to(dev)
            hs, drop = rank_step_seeds(spec["seed"] + it, rank, len(sizes))
            return step(state, dist.shard, dist._g2h, dist._g2l,
                        spec["indptr"], spec["indices"], seeds,
                        labels[seeds.long()], hs, drop)

        def loop(count, state, it0):
            out = loss = None
            for i, out in enumerate(pipelined(lookup, batches(count))):
                state, loss = one_step(state, it0 + i)
            del out
            _sync(dev)
            return state, loss

        box = {"state": state, "it": 0}

        def warm():
            box["state"], _ = loop(WARM, box["state"], box["it"])
            box["it"] += WARM

        passes = warm_up(dev, warm, agree=lambda grew: _any(grew, groups))
        state = box["state"]
        probe = Probe(4, "compact-exchange dist lookups + dist steps", dev,
                      out_bytes=size * spec["dim"] * 4)
        for i, kind in enumerate(("narrow lookup", "fallback lookup")):
            with probe.unit(kind):
                lookup(torch.from_numpy(make_batch(i)).to(dev))
        with probe.unit("dist step"):
            state, _ = one_step(state, 50)
            _sync(dev)
        fns = dict(dist._lookup_fns)
        probe.base(cycles=spec["cycles"])
        state, loss = loop(spec["cycles"], state, 100)
        half = spec["cycles"] // 2
        probe.window({"narrow lookup": spec["cycles"] - half,
                      "fallback lookup": half, "dist step": spec["cycles"]})
        check(dist._lookup_fns == fns,
              "the compact dist lookup built new lookup functions mid-loop")
        check(bool(torch.isfinite(loss)), "non-finite dist loss")
        return probe.end(rank=rank, lookups=spec["cycles"],
                         steps=spec["cycles"], cap=cap, warm_passes=passes)
    return _rank_probe(rank, groups, body)


class _SpecWorld:
    """The widths of a spec as :func:`new_model` reads them."""

    def __init__(self, spec):
        self.dim, self.hidden, self.classes = (spec["dim"], spec["hidden"],
                                               spec["classes"])
        self.sizes, self.device = spec["sizes"], torch.device(spec["device"])


_SPEC_TENSORS = ("indptr", "indices", "labels", "feat")


def _spec(w: World, **kw) -> dict:
    """What a rank builds its part from. The tensors go to the ranks as
    CPU tensors in shared memory, not by CUDA IPC, and each rank puts
    its own copies on its card (:func:`_on_device`), so this process
    exports no device memory: inside ``chip_smoke.py``, after earlier
    phases had sent ranks CUDA tensors, a later phase's first lookup
    raised ``cudaErrorAlreadyMapped`` once these were sent by IPC too."""
    if "host" not in w._cache:
        w._cache["host"] = {"indptr": w.indptr.cpu(),
                            "indices": w.indices.cpu(),
                            "labels": w.labels.cpu(), "feat": w.feat}
    return dict(device=str(w.device), n=w.n, dim=w.dim, hidden=w.hidden,
                classes=w.classes, sizes=list(w.sizes), batch=w.batch,
                cycles=w.cycles, seed=w.seed, row_cap=w.row_cap,
                **w._cache["host"], **kw)


def _on_device(spec: dict) -> dict:
    dev = torch.device(spec["device"])
    return dict(spec, **{k: spec[k].to(dev) for k in _SPEC_TENSORS})


def phase_dist(w: World) -> dict:
    g2h = w.rng.integers(0, RANKS, w.n).astype(np.int32)
    g2h[:RANKS] = np.arange(RANKS)
    per_rank = ranks_of(w).run(_dist_rank, _spec(
        w, g2h=g2h, cap=32, dist_batch=w.dist_batch))
    return _ranks_record(4, "compact-exchange dist lookups + dist steps",
                         per_rank)


# -- phase 5: the metrics path ------------------------------------------------


def phase_metrics(w: World) -> dict:
    from . import metrics
    from .ops.kernels import _build
    from .pipeline import pipelined
    dev, rng = w.device, w.rng
    store = fp32_store(w, dedup_cold=True, cold_budget=w.cold_budget,
                       host_placement="offload")
    stats = metrics.StepStats(fold_every=8)
    tmp = tempfile.mkdtemp(prefix="qt_leak_metrics_")
    sink = metrics.MetricsSink(os.path.join(tmp, "metrics.jsonl"))
    state, step, draw = trainer(w, collect_metrics=True, seed=2)
    feat = w.feat_device()

    def metered_lookup(ids):
        rows, counters = store.lookup_tiered(ids, collect_metrics=True)
        _sync(dev)
        stats.add_counters(counters)
        return rows

    def one_step(state):
        seeds = train_seeds(w, rng, w.batch)
        hs, drop = draw()
        t0 = time.perf_counter()
        state, loss, counters = step(state, feat, None, w.indptr, w.indices,
                                     seeds, w.labels[seeds.long()], hs, drop)
        stats.record_step(time.perf_counter() - t0, counters)
        return state, loss

    def loop(count, state, emit):
        out = loss = None
        for i, out in enumerate(pipelined(
                metered_lookup, dup_batches(rng, w.n, count, w.lookup,
                                            dev))):
            state, loss = one_step(state)
            if emit and i % 10 == 9:
                sink.emit_stats(stats)
        del out
        _sync(dev)
        return state, loss

    try:
        box = {"state": state}

        def warm():
            box["state"], _ = loop(WARM, box["state"], False)

        passes = warm_up(dev, warm)
        state = box["state"]
        stats.watch_compiles(_build.loaded_libraries)
        probe = Probe(5, "metered lookups + metered steps", dev,
                      out_bytes=w.lookup * w.dim * 4)
        with probe.unit("metered lookup"):
            metered_lookup(next(dup_batches(rng, w.n, 1, w.lookup, dev)))
        with probe.unit("metered step"):
            state, _ = one_step(state)
            _sync(dev)
        probe.base(cycles=w.cycles)
        state, loss = loop(w.cycles, state, True)
        probe.window({"metered lookup": w.cycles,
                      "metered step": w.cycles})
        snap = stats.snapshot()
        sink.close()
        recs = metrics.read_jsonl(os.path.join(tmp, "metrics.jsonl"))
        check(snap["recompiles"] == 0,
              f"StepStats saw {snap['recompiles']} kernel libraries loaded")
        check(snap["steps"] == WARM * passes + 1 + w.cycles
              and snap["counters"]["frontier_cap"] > 0,
              f"StepStats filed {snap['steps']} steps")
        check(len(recs) == w.cycles // 10 + 1 and recs[0]["kind"] == "meta"
              and all(r["kind"] == "step_stats" and "counters" in r
                      for r in recs[1:]),
              f"the sink holds {[r['kind'] for r in recs]}")
        return probe.end(recompiles=snap["recompiles"], steps=snap["steps"],
                         sink_records=len(recs), warm_passes=passes)
    finally:
        store.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phases 6 and 7: the request path -----------------------------------------


def _settle(server, rng, n: int, count: int) -> None:
    wait_all([server.submit(int(i)) for i in rng.integers(0, n, count)])


def _held_wave(server, gate: Gate, rng, n: int, count: int) -> None:
    """``count`` requests submitted while the engine is held, then
    served (the futures are dropped: a row is a view of its batch's host
    copy)."""
    gate.shut()
    try:
        futs = [server.submit(int(i)) for i in rng.integers(0, n, count)]
    finally:
        gate.open()
    wait_all(futs)


def phase_serving(w: World) -> dict:
    from . import MicroBatchServer, ServeConfig
    dev, rng = w.device, w.rng
    gate = Gate(engine_of(w))
    server = MicroBatchServer(gate, ServeConfig(
        max_wait_ms=1.0, queue_depth=256, shed_queue_frac=0.1,
        calm_batches=2), stats=served_stats())
    # while the gate is shut the coalescer and the pipeline hold at most
    # 3 batches of the fill cap; the rest of the wave waits in the queue,
    # past the shed threshold (25)
    server.set_batch_fill_cap(16)
    check(w.requests - 3 * 16 >= 25 + 1,
          f"phase premise: a wave of {w.requests} cannot back up")
    try:
        probe = Probe(6, "served requests across the shed ladder", dev,
                      out_bytes=logits_bytes(w))
        # the warm-up is a wave as the measured one: every variant runs
        # at the wave's fill before the base
        def wave():
            with probe.served(server):
                _held_wave(server, gate, rng, w.n, w.requests)

        passes = warm_up(dev, wave)
        probe.base()
        mix0 = server.snapshot()["serving"]["variant_batches"]
        with probe.served(server):
            _held_wave(server, gate, rng, w.n, w.requests)
        snap = server.snapshot()
        mix = [b - a for a, b in zip(mix0, snap["serving"]["variant_batches"])]
        check(snap["serving"]["failed"] == 0, "a served request failed")
        check(sum(1 for b in mix if b) >= 2,
              f"the wave never left the full fanout (variant mix {mix})")
        check(snap["recompiles"] == 0, "the server's watch saw "
              f"{snap['recompiles']} kernel libraries loaded")
        check(snap["request"]["count"] == (passes + 1) * w.requests,
              "the server filed another count of requests than it served")
        return probe.end(requests=w.requests, variant_mix=mix,
                         recompiles=snap["recompiles"], warm_passes=passes)
    finally:
        server.close()


def phase_tracing(w: World) -> dict:
    from . import MicroBatchServer, ServeConfig, tracing
    dev, rng = w.device, w.rng
    ring_cap = 256
    tracing.enable(capacity=ring_cap)
    tmp = tempfile.mkdtemp(prefix="qt_leak_trace_")
    gate = Gate(engine_of(w))
    server = MicroBatchServer(gate, ServeConfig(
        max_wait_ms=1.0, queue_depth=256, shed_queue_frac=0.1,
        slo_p99_ms=50.0, calm_batches=2), stats=served_stats())
    try:
        probe = Probe(7, "traced + metered serving", dev,
                      out_bytes=logits_bytes(w))
        # held waves: the warm-up's batches as the measured wave's
        def wave():
            with probe.served(server):
                _held_wave(server, gate, rng, w.n, w.requests)

        passes = warm_up(dev, wave)
        probe.base()
        with probe.served(server):
            _held_wave(server, gate, rng, w.n, w.requests)
        snap = server.snapshot()
        tracer = tracing.get_tracer()
        nspans = len(tracer)
        check(nspans == ring_cap and len(tracer._ring) == ring_cap,
              f"the span ring holds {nspans} spans in {len(tracer._ring)} "
              f"slots (capacity {ring_cap}; the wave's spans exceed it)")
        check(snap["recompiles"] == 0, "a kernel library loaded under "
              "traced serving")
        check(snap["slo"]["total"]["requests"] >= w.requests,
              "the SLO budget missed requests")
        path = os.path.join(tmp, "trace.json")
        exported = tracing.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        check(exported == nspans and len(doc["traceEvents"]) >= exported,
              "the Chrome trace did not round-trip")
        return probe.end(spans=nspans, ring=ring_cap, exported=exported,
                         recompiles=snap["recompiles"], warm_passes=passes)
    finally:
        server.close()
        tracing.disable()
        tracing.clear()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phases 8 and 11: the disk tier -------------------------------------------


def artifact_of(w: World) -> str:
    """An int8 disk-tier artifact of ``w.feat`` (written once a run)."""
    if "artifact" not in w._cache:
        from .partition import save_disk_tier
        path = tempfile.mkdtemp(prefix="qt_leak_disk_")
        save_disk_tier(w.feat, np.arange(w.n, dtype=np.int64), path,
                       dtype_policy="int8", overwrite=True)
        w._cache["artifact"] = path
    return w._cache["artifact"]


# a disk lookup's gathers that depend on its data: the ring gather (the
# loop design over the pinned ring) runs once when the lookup hits the
# ring and once more for each staging task it waits for (at most the
# staging depth, 2); with the hot tier's gather, at most 4 gather_rows
DISK_VARY = {"gather_rows": 4, "gather_rows_kernel": 3}


def touch_mapped(store) -> int:
    """Read one byte of every page of each mapping of the disk tier the
    store reads through (its arrays, and the extent reader's own mapping
    for the extents whose reads fail, which it makes at the first
    failure), so their pages are resident (module doc); the bytes
    touched."""
    page = os.sysconf("SC_PAGE_SIZE")
    total = 0
    arrays = [store.mmap_array, store.disk_scale, store.disk_zero]
    reader = store._cold_prefetch._reader
    if reader is not None:
        arrays.append(reader._fallback_mmap())
    for a in arrays:
        if isinstance(a, np.memmap):
            flat = np.asarray(a).reshape(-1).view(np.uint8)
            int(flat[::page].sum())
            total += flat.nbytes
    return total


def ring_buffers(pf) -> tuple:
    """The staging ring's buffers: the ring table's storages and the slot
    index's, by address."""
    from .ops import quant
    ring = pf._ring
    parts = tuple(p.data_ptr() for p in quant.tier_parts(ring.table)
                  if p is not None)
    return parts + (ring._slot_of.ctypes.data, ring.rows.ctypes.data)


def phase_disk(w: World) -> dict:
    from .metrics import StepStats
    from .ops.kernels import _build
    from .partition import load_disk_tier_store
    dev, rng = w.device, w.rng
    threads0 = set(thread_names())
    hot, ring_cap, cbatch, ccold = w.n // 2, 2048, 1024, 512
    store, _ = load_disk_tier_store(artifact_of(w), hot_rows=hot,
                                    prefetch_rows=ring_cap, workers=2,
                                    io_qd=4, device=dev)
    pf = store._cold_prefetch
    check(pf.workers == 2 and pf._stagers is not None,
          "phase premise: two staging workers")
    mapped = touch_mapped(store)
    buffers = ring_buffers(pf)
    wmat = torch.from_numpy(rng.standard_normal((w.dim, w.dim))
                            .astype(np.float32)).to(dev)
    stats = StepStats(fold_every=8)

    def cold_batch():
        a = np.concatenate([rng.integers(hot, w.n, ccold),
                            rng.integers(0, hot, cbatch - ccold)])
        rng.shuffle(a)
        return a.astype(np.int64)

    def cycle(ids_now, ids_next, publish=True):
        rows, counters = store.lookup_tiered(ids_now, collect_metrics=True)
        if publish:
            store.stage_frontier(ids_next)
        float(torch.tanh(rows @ wmat).sum())
        stats.add_counters(counters)

    try:
        box = {"next": cold_batch()}
        store.stage_frontier(box["next"]).result()

        def warm():
            for _ in range(WARM):
                ids_now, box["next"] = box["next"], cold_batch()
                cycle(ids_now, box["next"])

        passes = warm_up(dev, warm)
        ids_next = box["next"]
        stats.watch_compiles(_build.loaded_libraries)
        probe = Probe(8, "frontier-ahead disk-tier prefetch", dev,
                      out_bytes=cbatch * w.dim * 4, vary=DISK_VARY)
        probe.base(cycles=w.cycles)
        for i in range(w.cycles):
            ids_now, ids_next = ids_next, cold_batch()
            with probe.unit("disk lookup"):
                cycle(ids_now, ids_next, publish=(i % 5 != 4))
            check(pf._ring.filled <= ring_cap,
                  "the staging ring exceeded its capacity")
        snap = stats.snapshot()
        ps = pf.stats()
        check(snap["recompiles"] == 0, "a kernel library loaded mid-loop")
        check(ring_buffers(pf) == buffers,
              "the staging ring reallocated a buffer (eviction must "
              "overwrite in place)")
        check(ps["filled"] == ring_cap and ps["staged_rows"] > ring_cap,
              f"the ring never wrapped ({ps['filled']}/{ring_cap} filled, "
              f"{ps['staged_rows']} staged)")
        check(ps["hit_rows"] > 0 and ps["sync_rows"] > 0,
              "phase premise: both ring hits and synchronous reads")
        check(snap["counters"]["prefetch_hit_rows"] == ps["hit_rows"],
              "the counters disagree with the prefetcher's hits")
        check(ps["io"]["extents"] > 0,
              "phase premise: staging through the extent reader")
        rec = probe.end(recompiles=snap["recompiles"], ring=ring_cap,
                        filled=ps["filled"], staged_rows=ps["staged_rows"],
                        hit_rows=ps["hit_rows"], sync_rows=ps["sync_rows"],
                        warm_passes=passes, mapped_bytes=mapped)
    finally:
        store.close()
    check(pf.closed, "close() left the staging pipeline running")
    left = [t for t in set(thread_names()) - threads0
            if t.startswith(STAGER_THREADS)]
    check(not left, f"close() left staging threads alive: {left}")
    rec["threads_left"] = left
    return rec


# -- phase 9: the telemetry hub -----------------------------------------------


def phase_hub(w: World) -> dict:
    from . import metrics
    from .ops.kernels import _build
    from .telemetry import PlanContext, TelemetryHub
    dev, rng = w.device, w.rng
    ring = max(2, w.cycles // 2)     # < the loop's lookups: series wrap
    store = fp32_store(w, dedup_cold=True, cold_budget=w.cold_budget,
                       host_placement="offload")
    tmp = tempfile.mkdtemp(prefix="qt_leak_hub_")
    path = os.path.join(tmp, "hub.jsonl")
    sink = metrics.MetricsSink(path, max_bytes=256_000)
    hub = TelemetryHub(capacity=ring, window=4, fold_every=8, sink=sink,
                       plan=PlanContext(hot_capacity=store.cache_rows,
                                        total_rows=w.n,
                                        dedup_budget=w.cold_budget))
    state, step, draw = trainer(w, collect_metrics=True, seed=4)
    feat = w.feat_device()

    def hub_lookup(ids):
        rows, counters = store.lookup_tiered(ids, collect_metrics=True)
        _sync(dev)
        hub.observe_counters(counters)

    def hub_step(state):
        seeds = train_seeds(w, rng, w.batch)
        hs, drop = draw()
        t0 = time.perf_counter()
        state, loss, counters = step(state, feat, None, w.indptr, w.indices,
                                     seeds, w.labels[seeds.long()], hs, drop)
        _sync(dev)
        hub.observe_step(time.perf_counter() - t0, counters)
        return state, loss

    try:
        box = {"state": state}

        def warm():
            for ids in dup_batches(rng, w.n, WARM, w.lookup, dev):
                hub_lookup(ids)
                box["state"], _ = hub_step(box["state"])

        passes = warm_up(dev, warm)
        state = box["state"]
        hub.flush()
        hub.watch_compiles(_build.loaded_libraries)
        probe = Probe(9, "telemetry hub + detectors + advisor", dev,
                      out_bytes=w.lookup * w.dim * 4)
        probe.base(cycles=w.cycles)
        for i, ids in enumerate(dup_batches(rng, w.n, w.cycles, w.lookup,
                                            dev)):
            with probe.unit("metered lookup"):
                hub_lookup(ids)
            with probe.unit("metered step"):
                state, loss = hub_step(state)
            if i % 10 == 9:
                hub.replan()
        del ids
        hub.flush()
        recompiles = hub.series.get("recompiles")
        hits = hub.series["hot_hit_rate"]
        check(recompiles is not None
              and float(recompiles.values().max()) == 0.0,
              "the hub's watch saw a kernel library loaded")
        check(not any(a["series"] == "recompiles" for a in hub.anomalies),
              "the spike detector fired on recompiles")
        check(len(hits) == ring and hits.wrapped,
              f"the series ring did not wrap ({len(hits)}/{ring})")
        advice = hub.advice.get("dedup_budget")
        check(advice is not None and advice["recommended"] > w.cold_budget,
              "the advisor missed the observed dedup-budget overflow")
        rec = probe.end(series_len=len(hits), series_total=hits.total,
                        advice=sorted(hub.advice),
                        recommended_budget=advice["recommended"],
                        warm_passes=passes)
        sink.close()
        kinds = [r["kind"] for r in metrics.read_jsonl(path)]
        check("advice" in kinds, "no advice record reached the sink")
        return rec
    finally:
        sink.close()
        store.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 10: a profile pass -------------------------------------------------


def frontier_cap(w: World) -> int:
    cap = w.batch
    for k in w.sizes:
        cap *= 1 + k
    return cap


def phase_profile(w: World) -> dict:
    from types import SimpleNamespace
    from . import metrics
    from .analysis import registry
    from .ops.kernels import _build
    from .parallel import init_state
    from .profile import StageProfiler, machine_probe
    from .telemetry import TelemetryHub
    dev, rng = w.device, w.rng
    tmp = tempfile.mkdtemp(prefix="qt_leak_prof_")
    path = os.path.join(tmp, "prof.jsonl")
    sink = metrics.MetricsSink(path)
    hub = TelemetryHub(capacity=32, window=4)
    model = new_model(w, seed=6)
    seeds = train_seeds(w, rng, w.batch)
    fixture = SimpleNamespace(
        indptr=w.indptr, indices=w.indices, feat=w.feat_device(),
        forder=None, seeds=seeds, labels=w.labels[seeds.long()],
        sizes=list(w.sizes),
        state=init_state(model, torch.optim.Adam(model.parameters(),
                                                 lr=1e-3)),
        row_cap=w.row_cap, hop_seeds=list(range(101, 101 + len(w.sizes))))
    try:
        prof = StageProfiler(reps=2, probe=machine_probe(quick=True,
                                                         device=dev),
                             sink=sink, hub=hub)
        prof.add_registry(quick=True, device=dev)
        prof.add_pipeline(fixture=fixture, device=dev)
        probe = Probe(10, "profile pass over the quick registry", dev,
                      out_bytes=frontier_cap(w) * w.dim * 4)
        with probe.unit("profile pass"):
            prof.run()
        watch = metrics.StepStats().watch_compiles(_build.loaded_libraries)
        probe.base()
        with probe.unit("profile pass"):
            recs = prof.run()
        entries = [r["entry"] for r in recs]
        snap = watch.snapshot()
        check(snap["recompiles"] == 0, "the profile pass loaded "
              f"{snap['recompiles']} kernel libraries")
        check("train_pipeline" in entries and "serve_step" in entries,
              f"the pass profiled {entries}")
        check(any(s.startswith("stage_share:") for s in hub.series),
              "the pass fed no stage-share series")
        rec = probe.end(entries=entries, recompiles=snap["recompiles"])
        sink.close()
        kinds = [r["kind"] for r in metrics.read_jsonl(path)
                 if r["kind"] != "meta"]
        check(kinds and all(k == "profile" for k in kinds),
              f"the sink holds {sorted(set(kinds))}")
        return rec
    finally:
        sink.close()
        registry.release_group()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 11: an active fault plan -------------------------------------------


def phase_faults(w: World) -> dict:
    from . import MicroBatchServer, ServeConfig, faults
    from .metrics import StepStats
    from .ops.kernels import _build
    from .partition import load_disk_tier_store
    dev, rng = w.device, w.rng
    hot, half = w.n // 2, 256
    store, _ = load_disk_tier_store(artifact_of(w), hot_rows=hot,
                                    prefetch_rows=1024, workers=2, io_qd=4,
                                    device=dev)
    mapped = touch_mapped(store)
    server = MicroBatchServer(engine_of(w), ServeConfig(max_wait_ms=1.0),
                              stats=served_stats())
    stats = StepStats(fold_every=8)

    def fault_batch():
        return np.concatenate([rng.integers(hot, w.n, half),
                               rng.integers(0, hot, half)]).astype(np.int64)

    def loop(count, unit):
        """``count`` prefetched disk lookups, then 30 served requests."""
        ids_next = fault_batch()
        store.stage_frontier(ids_next)
        for _ in range(count):
            ids_now, ids_next = ids_next, fault_batch()
            with unit("disk lookup"):
                rows, counters = store.lookup_tiered(ids_now,
                                                     collect_metrics=True)
                store.stage_frontier(ids_next)
                float(torch.tanh(rows).sum())
            stats.add_counters(counters)
        del rows
        with probe.served(server):
            _settle(server, rng, w.n, 30)

    try:
        check_ids = fault_batch()
        store.stage_frontier(check_ids)
        want = store[check_ids].cpu()
        probe = Probe(11, "active storage-fault plan", dev,
                      out_bytes=2 * half * w.dim * 4, vary=DISK_VARY)
        passes = warm_up(dev, lambda: loop(WARM, probe.unit))
        stats.watch_compiles(_build.loaded_libraries)
        probe.base(cycles=w.cycles)
        faults.install(faults.FaultPlan(seed=13, rules={
            "io.read": faults.FaultRule("error", errno_name="EINTR",
                                        rate=0.3),
            "io.slow": faults.FaultRule("delay", delay_ms=1.0, rate=0.2),
            "prefetch.stager": faults.FaultRule("error", exc="runtime",
                                                times=1)}))
        try:
            loop(w.cycles, probe.unit)
            injected = faults.active().injected
        finally:
            faults.disarm()
        snap = stats.snapshot()
        c = snap["counters"]
        check(injected > 0, "phase premise: the armed plan must fire")
        check(c["io_retries"] > 0, "phase premise: the retry ladder ran")
        check(c["faults_injected"] > 0,
              "the faults_injected slot never drained the plan's count")
        check(snap["recompiles"] == 0, "a kernel library loaded under "
              "the fault plan")
        got = store[check_ids].cpu()
        check(torch.equal(want.view(torch.int32), got.view(torch.int32)),
              "rows read after the fault plan differ from those before")
        del got
        return probe.end(injected=injected, io_retries=c["io_retries"],
                         staging_worker_restarts=c[
                             "staging_worker_restarts"],
                         recompiles=snap["recompiles"], warm_passes=passes,
                         mapped_bytes=mapped)
    finally:
        server.close()
        store.close()


# -- phase 12: tail sampling under eviction pressure --------------------------


def phase_tail(w: World) -> dict:
    from . import MicroBatchServer, ServeConfig, metrics, tracing
    from .tailsampling import TailSampler
    dev, rng = w.device, w.rng
    pending_cap, ring_cap, burst = 8, 256, 24
    tracing.enable(capacity=ring_cap)
    tmp = tempfile.mkdtemp(prefix="qt_leak_tail_")
    path = os.path.join(tmp, "tail.jsonl")
    sink = metrics.MetricsSink(path)
    sampler = TailSampler(sink=sink, max_pending=pending_cap,
                          latency_source=lambda: 1e9, head_rate=0.05,
                          seed=3).attach()
    gate = Gate(engine_of(w))
    # a batch waits 50 ms for company (JAX: 1 ms), so while the engine is
    # held the first batch takes the whole burst: more traces pending at
    # once than the table holds
    server = MicroBatchServer(gate, ServeConfig(
        max_wait_ms=50.0, queue_depth=256, shed_queue_frac=0.5),
        stats=served_stats())
    try:
        probe = Probe(12, "tail sampling under eviction pressure", dev,
                      out_bytes=logits_bytes(w))
        def burst_wave():
            with probe.served(server):
                _held_wave(server, gate, rng, w.n, burst)

        passes = warm_up(dev, burst_wave)
        probe.base()
        for _ in range(w.bursts):
            with probe.served(server):
                evicted = sampler.stats()["evicted"]
                gate.shut()
                try:
                    futs = [server.submit(int(i))
                            for i in rng.integers(0, w.n, burst)]
                    # hold the burst until the pending table overflowed
                    # (or 10 s passed: the premise check below decides)
                    deadline = time.perf_counter() + 10.0
                    while sampler.stats()["evicted"] == evicted \
                            and time.perf_counter() < deadline:
                        time.sleep(0.001)
                finally:
                    gate.open()
                wait_all(futs)
        del futs
        snap = server.snapshot()
        st = sampler.stats()
        served = w.bursts * burst
        check(st["evicted"] > 0,
              "phase premise: bursts overflow the pending table")
        check(st["completed"] >= served,
              "requests completed without a keep or drop decision")
        check(st["pending_high_water"] <= pending_cap,
              f"the pending table reached {st['pending_high_water']} "
              f"(bound {pending_cap})")
        check(st["kept"] > 0, "phase premise: the head-sampling floor "
              "keeps a few")
        check(len(tracing.get_tracer()) <= ring_cap,
              "the tracer ring exceeded its capacity")
        check(snap["recompiles"] == 0, "a kernel library loaded under "
              "tail sampling")
        rec = probe.end(kept=st["kept"], dropped=st["dropped"],
                        evicted=st["evicted"],
                        high_water=st["pending_high_water"],
                        pending_capacity=st["pending_capacity"],
                        warm_passes=passes)
        sink.close()
        kinds = {r["kind"] for r in metrics.read_jsonl(path)}
        check(kinds <= {"meta", "trace"} and "trace" in kinds,
              f"the sink holds {sorted(kinds)}")
        return rec
    finally:
        gate.open()
        sampler.detach()
        tracing.disable()
        tracing.clear()
        server.close()
        sink.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 13: actuation ------------------------------------------------------


def phase_actuator(w: World) -> dict:
    from . import Actuator, MicroBatchServer, ServeConfig
    dev, rng = w.device, w.rng
    act_store, ctl_store = int8_store(w), int8_store(w)
    server = MicroBatchServer(engine_of(w), ServeConfig(
        max_wait_ms=1.0, queue_depth=256, shed_queue_frac=0.5),
        stats=served_stats())
    clock = [0.0]
    act = Actuator(clock=lambda: clock[0], cooldown_s=1.0, settle_s=0.0)
    act.attach_server(server)
    c = w.cycles
    ids_seq = [rng.integers(0, w.n, 512).astype(np.int32) for _ in range(c)]
    # three swaps on the census lattices and one point off them, which is
    # refused; two rotations between them
    swaps = {c // 5: ("batch_cap", 32), 2 * c // 5: ("max_wait_ms", 0.5),
             c // 2: ("batch_cap", 48), 3 * c // 5: ("batch_cap", 64)}
    rotate_at = (3 * c // 10, 7 * c // 10)
    check(len(set(swaps) | set(rotate_at)) == 6 and c >= 10,
          f"{c} cycles cannot place the swaps and rotations apart")
    def rotate():
        order = act_store._order_host()
        cold = np.nonzero(order >= act_store.cache_rows)[0][:64]
        act.observe_ids(np.tile(cold, 3), total_rows=w.n)
        r = act.maybe_rotate(act_store, max_rows=64)
        check(r is not None and r["rotated"] > 0,
              "phase premise: the rotation must rotate")

    try:
        for s in (act_store, ctl_store):
            s.lookup_tiered(torch.from_numpy(ids_seq[0]).to(dev),
                            collect_metrics=True)
        probe = Probe(13, "actuated swaps + hot-set rotations", dev,
                      out_bytes=2 * 512 * w.dim * 4)

        def warm():
            # a rotation (the first allocates the new hot tier beside the
            # old one, and leaves the topology the order the store was
            # built with, as in JAX), the swaps' traffic, lookup pairs
            clock[0] -= 10.0
            rotate()
            for _ in range(2):
                with probe.served(server):
                    _settle(server, rng, w.n, 8)
            for ids in ids_seq[:WARM]:
                jids = torch.from_numpy(ids).to(dev)
                act_store.lookup_tiered(jids, collect_metrics=True)
                ctl_store.lookup_tiered(jids)

        clock[0] = -100.0
        passes = warm_up(dev, warm)
        probe.base(cycles=len(ids_seq))
        rotations = 0
        for i, ids in enumerate(ids_seq):
            clock[0] = float(i)
            if i in swaps:
                key, value = swaps[i]
                act.tick([{"key": key, "recommended": value,
                           "observed": {}, "reason": "phase 13"}])
                with probe.served(server):
                    wait_all([server.submit(int(v)) for v in ids[:8]])
            if i in rotate_at:
                with probe.reallocating():
                    rotate()
                rotations += 1
            jids = torch.from_numpy(ids).to(dev)
            with probe.unit("lookup pair"):
                rows_a, _ = act_store.lookup_tiered(jids,
                                                    collect_metrics=True)
                rows_b = ctl_store.lookup_tiered(jids)
                _sync(dev)
            if not torch.equal(rows_a.view(torch.int32),
                               rows_b.view(torch.int32)):
                raise LeakError(f"step {i}: actuated rows differ from the "
                                "control's: " + _row_diff(
                                    act_store, ctl_store, jids, rows_a,
                                    rows_b))
        del rows_a, rows_b, jids
        snap = server.snapshot()
        knobs = server.knobs()
        check(act.applied >= 3 + passes + rotations and rotations == 2,
              f"applied {act.applied}, rotations {rotations}")
        check(act.refused == 1, f"refused {act.refused}, want 1")
        check(knobs["batch_fill_cap"] == 64 and knobs["max_wait_ms"] == 0.5,
              f"knobs {knobs}")
        check(snap["recompiles"] == 0, "a kernel library loaded across "
              "the swaps")
        return probe.end(applied=act.applied, refused=act.refused,
                         rotations=rotations, warm_passes=passes)
    finally:
        server.close()
        act_store.close()
        ctl_store.close()


def _row_diff(a, b, ids, rows_a, rows_b) -> str:
    """Where two stores' rows of ``ids`` differ: how many, and for the
    first such id each store's storage row and tier, both rows' leading
    values and a second lookup of it from each store."""
    bad = (rows_a.view(torch.int32) != rows_b.view(torch.int32)).any(1)
    k = int(bad.nonzero()[0, 0])
    node = int(ids[k])
    ra, rb = int(a.feature_order[node]), int(b.feature_order[node])
    again = [s.lookup_tiered(ids[k:k + 1])[0, :4].tolist() for s in (a, b)]
    return (f"{int(bad.sum())} of {ids.shape[0]} rows; node {node}: "
            f"storage rows {ra} / {rb} (hot below {a.cache_rows} / "
            f"{b.cache_rows}), rows {rows_a[k, :4].tolist()} / "
            f"{rows_b[k, :4].tolist()}, looked up again {again}")


# -- phase 14: sharded serving ------------------------------------------------


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).cpu().contiguous().view(torch.uint8) \
        .numpy().tobytes()


def _sharded_rank(rank, world_size, groups, spec):
    spec = _on_device(spec)

    def body():
        from . import (DistFeature, PartitionInfo, ServeEngine,
                       ShardedServeEngine, TorchComm, metrics)
        dev = torch.device(spec["device"])
        n, bs, sizes = spec["n"], spec["shard_batch"], spec["sizes"]
        rng = np.random.default_rng(spec["seed"] + 14)   # every rank's own
        g2h = (np.arange(n) % world_size).astype(np.int32)
        info = PartitionInfo(host=rank, hosts=world_size, global2host=g2h)
        dist = DistFeature.from_partition(
            spec["feat"], info, TorchComm(rank, world_size,
                                          group=groups["lookup"]),
            exchange_cap=spec["cap"], collect_metrics=True, device=dev)
        sw = _SpecWorld(spec)
        topo = (spec["indptr"], spec["indices"])
        sharded = ShardedServeEngine(
            new_model(sw, seed=5), None, topo, dist, [sizes], bs,
            collect_metrics=True, fused_hot_hop=True,
            fused_row_cap=spec["row_cap"], seed=5)
        control = ServeEngine(new_model(sw, seed=5), None, topo,
                              spec["feat"], [sizes], bs, fused_hot_hop=True,
                              fused_row_cap=spec["row_cap"], seed=5,
                              device=dev)

        def batch(i):
            # even: 4 distinct seeds, whose frontier fits the narrow
            # exchange; odd: a full block of distinct seeds, whose
            # frontier overflows it (held below by the counters)
            return rng.choice(n, 4 if i % 2 == 0 else bs,
                              replace=False).astype(np.int32)

        probe = Probe(14, "sharded serving, narrow and fallback", dev,
                      out_bytes=2 * bs * spec["classes"] * 4)
        narrow = fallback = 0
        def warm():
            for i in range(WARM):
                ids = batch(i)
                sharded.run(ids)
                control.run(ids)

        with deterministic(dev):
            passes = warm_up(dev, warm,
                             agree=lambda grew: _any(grew, groups))
            probe.base(cycles=spec["cycles"])
            for i in range(spec["cycles"]):
                ids = batch(i)
                kind = "narrow" if i % 2 == 0 else "fallback"
                with probe.unit(kind + " batch"):
                    got = sharded.run(ids)
                    _sync(dev)
                with probe.unit("unsharded batch"):
                    want = control.run(ids)
                    _sync(dev)
                check(_bits(got) == _bits(want),
                      f"batch {i}: sharded logits differ from the "
                      "unsharded engine's")
                c = sharded.last_counters.cpu().numpy().reshape(-1)
                check(c[metrics.EXCH_CALLS] > 0, "no exchange ran")
                if i % 2 == 0:
                    check(c[metrics.EXCH_FALLBACK] == 0, f"batch {i}: "
                          "phase premise: a narrow batch fell back")
                    narrow += 1
                else:
                    check(c[metrics.EXCH_FALLBACK] > 0, f"batch {i}: "
                          "phase premise: a wide batch stayed narrow")
                    fallback += 1
            del got, want
        return probe.end(rank=rank, narrow=narrow, fallback=fallback,
                         cap=spec["cap"], warm_passes=passes)
    return _rank_probe(rank, groups, body)


def phase_sharded(w: World) -> dict:
    per_seed = 1
    for k in w.sizes:
        per_seed *= 1 + k
    cap = 1 << (4 * per_seed - 1).bit_length()
    per_rank = ranks_of(w).run(_sharded_rank, _spec(
        w, cap=cap, shard_batch=64))
    return _ranks_record(14, "sharded serving, narrow and fallback",
                         per_rank)


# -- phase 15: the fused walk against the split replay ------------------------


def phase_fused(w: World) -> dict:
    from .ops.kernels.fused import fused_multihop, fused_multihop_reference
    from .parallel import build_train_step, init_state
    from .parallel.train import _model_loss, _update, layers_to_adjs
    from .serving import build_serve_step
    dev, rng = w.device, w.rng
    feat, sizes, bs, cap = w.feat_device(), w.sizes, w.batch, w.row_cap
    gen = torch.Generator().manual_seed(w.seed + 15)

    def draw(k):
        return torch.randint(-2**31, 2**31 - 1, (k,), generator=gen).tolist()

    model_f, model_o = new_model(w, 0.5, seed=2), new_model(w, 0.5, seed=2)
    opt_f = torch.optim.Adam(model_f.parameters(), lr=1e-3)
    opt_o = torch.optim.Adam(model_o.parameters(), lr=1e-3)
    state_f, state_o = init_state(model_f, opt_f), init_state(model_o, opt_o)
    fstep = build_train_step(model_f, opt_f, sizes, bs, fused_hot_hop=True,
                             fused_row_cap=cap)
    serve_model = new_model(w, seed=7).eval()
    fserve = build_serve_step(serve_model, sizes, bs, fused_hot_hop=True,
                              fused_row_cap=cap)

    def oracle(state, seeds, labels, hop_seeds, drop):
        # the split replay of the fused step: the same walk through
        # sample_layer_kernel, the same dropout stream, the same update
        with torch.no_grad():
            _, layers, x = fused_multihop_reference(
                w.indptr, w.indices, seeds, feat, sizes, hop_seeds, cap)
        loss = _model_loss(model_o, x, layers_to_adjs(layers, bs, sizes),
                           labels, bs, drop)
        return _update(state, model_o, opt_o, loss), loss.detach()

    def cycle(probe, state_f, state_o):
        seeds = train_seeds(w, rng, bs)
        labels = w.labels[seeds.long()]
        hs = draw(len(sizes))
        with probe.unit("fused serve step"):
            logits = fserve(hs, feat, None, w.indptr, w.indices, seeds)
            _sync(dev)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        with probe.unit("fused walk"):
            g_nid, _, g_x = fused_multihop(w.indptr, w.indices, seeds, feat,
                                           sizes, hs, cap)
            _sync(dev)
        with probe.unit("split walk"):
            r_nid, _, r_x = fused_multihop_reference(
                w.indptr, w.indices, seeds, feat, sizes, hs, cap)
            _sync(dev)
        check(_bits(g_nid) == _bits(r_nid),
              "the fused frontier differs from the split replay's")
        valid = g_nid >= 0
        check(_bits(g_x[valid]) == _bits(r_x[valid]),
              "the fused rows differ from the split replay's")
        ths, drop = draw(len(sizes)), draw(1)[0]
        with probe.unit("fused train step"):
            state_f, loss_f = fstep(state_f, feat, None, w.indptr,
                                    w.indices, seeds, labels, ths, drop)
            _sync(dev)
        with probe.unit("split train step"):
            state_o, loss_o = oracle(state_o, seeds, labels, ths, drop)
            _sync(dev)
        check(_bits(loss_f) == _bits(loss_o),
              f"the fused loss {float(loss_f)} differs from the split "
              f"replay's {float(loss_o)}")
        return state_f, state_o

    with deterministic(dev):
        box = {"f": state_f, "o": state_o}

        def warm():
            for _ in range(WARM // 2):
                box["f"], box["o"] = cycle(Probe(15, "warm-up", dev),
                                           box["f"], box["o"])

        passes = warm_up(dev, warm)
        state_f, state_o = box["f"], box["o"]
        probe = Probe(15, "fused train + serve steps vs the split replay",
                      dev, out_bytes=frontier_cap(w) * w.dim * 4)
        # half the loop's cycles: a cycle here is five units (a served
        # batch, two walks, two train steps, under the deterministic
        # algorithms on the card)
        steps = max(1, w.cycles // 2)
        probe.base(cycles=steps)
        for _ in range(steps):
            state_f, state_o = cycle(probe, state_f, state_o)
        for a, b in zip(model_f.parameters(), model_o.parameters()):
            check(_bits(a) == _bits(b), "the fused parameters drifted from "
                  "the split replay's")
    return probe.end(steps=steps, warm_passes=passes)


# -- phase 16: a replayed multi-tenant flash crowd ----------------------------


def fold_tenants(trace: dict) -> Dict[str, int]:
    """The per-tenant arrivals of a ``traffic.generate_scenario`` trace,
    counted by hand."""
    fold = {name: 0 for name in trace["tenants"]}
    for i in np.asarray(trace["tenant"]).tolist():
        fold[trace["tenants"][i]] += 1
    return fold


class _LastArrival:
    """The replay's target: the server's ``submit``, opening ``gate``
    once the trace's last arrival has been offered."""

    def __init__(self, server, gate: Gate, arrivals: int):
        self._server, self._gate, self._left = server, gate, arrivals

    def submit(self, node, tenant=None):
        try:
            return self._server.submit(node, tenant=tenant)
        finally:
            self._left -= 1
            if self._left == 0:
                self._gate.open()


def phase_tenancy(w: World) -> dict:
    from . import MicroBatchServer, ServeConfig, traffic
    from .serving import default_tenant_classes
    dev, rng = w.device, w.rng
    depth, fill, pipe = 16, min(w.serve_cap, 64), 2
    gate = Gate(engine_of(w))
    server = MicroBatchServer(
        gate, ServeConfig(max_wait_ms=2.0, queue_depth=depth,
                          shed_queue_frac=0.25, calm_batches=2,
                          slo_p99_ms=50.0, pipeline_depth=pipe),
        tenants=default_tenant_classes(slo_p99_ms=50.0),
        stats=served_stats())
    server.set_batch_fill_cap(fill)
    trace = traffic.generate_scenario(
        "flash_crowd", 40.0, 25.0, w.n, seed=17,
        flash_tenant="best_effort", flash_x=10.0)
    arrivals = len(trace["tenant"])
    # while the gate is shut the server holds at most its queue and the
    # batches the coalescer and the pipeline hold: the rest must shed
    held = depth + (pipe + 2) * fill
    check(arrivals > held, f"phase premise: {arrivals} arrivals against "
          f"{held} places")
    try:
        probe = Probe(16, "replayed flash crowd across a shed episode", dev,
                      out_bytes=logits_bytes(w))
        with probe.served(server):
            wait_all([server.submit(int(i), tenant=t) for i, t in zip(
                rng.integers(0, w.n, 9),
                ["interactive", "batch", "best_effort"] * 3)])

        def held_replay():
            gate.shut()
            with probe.served(server):
                return traffic.replay(
                    trace, _LastArrival(server, gate, arrivals), speed=500.0)

        # the warm-up: shed episodes as the measured one
        passes = warm_up(dev, held_replay)
        probe.base()
        settle = {t["tenant"]: dict(t) for t in server.tenant_snapshots()}
        rep = held_replay()
        snap = server.snapshot()
        now = {t["tenant"]: t for t in server.tenant_snapshots()}
    finally:
        gate.open()
        server.close()
    fold = fold_tenants(trace)
    shed = 0
    for name in trace["tenants"]:
        r, b, t = rep["tenants"][name], settle[name], now[name]
        check(r["offered"] == fold[name],
              f"replay offered[{name}] differs from the trace's hand-fold")
        check(r["completed"] + r["rejected"] + r["deadline_expired"]
              + r["failed"] == r["offered"],
              f"the replay's records lose arrivals of {name}")
        check(t["completed"] - b["completed"] == r["completed"],
              f"completed drift for {name}")
        check(t["rejected"] + t["displaced"] - b["rejected"]
              - b["displaced"] == r["rejected"],
              f"reject/displace drift for {name}")
        check(t["deadline_expired"] - b["deadline_expired"]
              == r["deadline_expired"], f"deadline drift for {name}")
        check(t["failed"] - b["failed"] == r["failed"],
              f"failure drift for {name}")
        shed += r["rejected"]
    be = rep["tenants"]["best_effort"]["rejected"]
    ia = rep["tenants"]["interactive"]["rejected"]
    check(shed > 0, "the burst never shed")
    check(be >= ia, "shed order inverted: best_effort must absorb first")
    check(snap["recompiles"] == 0, "a kernel library loaded under the "
          "tenant-registry traffic")
    return probe.end(arrivals=arrivals, shed=shed, best_effort_shed=be,
                     interactive_shed=ia,
                     variant_mix=snap["serving"]["variant_batches"],
                     warm_passes=passes)


# -- the run ------------------------------------------------------------------

PHASES: Dict[int, Callable[[World], dict]] = {
    1: phase_prefetch, 2: phase_dedup, 3: phase_int8, 4: phase_dist,
    5: phase_metrics, 6: phase_serving, 7: phase_tracing, 8: phase_disk,
    9: phase_hub, 10: phase_profile, 11: phase_faults, 12: phase_tail,
    13: phase_actuator, 14: phase_sharded, 15: phase_fused,
    16: phase_tenancy}

_FACT_SKIP = {"phase", "name", "base", "end", "launches_per_cycle",
              "out_bytes", "ranks", "seconds"}


def _readings_text(rec: dict) -> str:
    r0, r1 = rec["base"], rec["end"]
    parts = [f"{k} {r0[k]} -> {r1[k]}" for k in
             ("live", "bytes", "large_segments", "small_segments",
              "libraries")]
    parts.append(f"rss {r0['rss_mb']:.1f} -> {r1['rss_mb']:.1f} MB")
    return ", ".join(parts)


def phase_line(rec: dict, card: str) -> str:
    """One phase's printed line: every reading's base and end, the
    launches per cycle by kernel, the phase's facts, the card."""
    facts = {k: v for k, v in rec.items() if k not in _FACT_SKIP}
    ranks = rec.get("ranks")
    readings_text = _readings_text(rec) if not ranks else "; ".join(
        f"rank {r}: {_readings_text(x)}" for r, x in enumerate(ranks))
    return (f"leak phase {rec['phase']} ({rec['name']}): {readings_text}; "
            f"launches per cycle {json.dumps(rec['launches_per_cycle'])}; "
            f"{json.dumps(facts, default=str)}; no leak in "
            f"{rec.get('seconds', 0.0):.2f} s; on {card}")


def run(w: World, phases=None, log=print) -> List[dict]:
    """Run ``phases`` (default all 16, in order) on ``w``, printing each
    phase's line through ``log``; raises :class:`LeakError` at the first
    phase that grew. Stops the ranks and removes the artifacts."""
    recs = []
    try:
        for number in (phases or sorted(PHASES)):
            t0 = time.perf_counter()
            rec = PHASES[int(number)](w)
            rec["seconds"] = time.perf_counter() - t0
            log(phase_line(rec, w.card))
            recs.append(rec)
    finally:
        w.close()
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m quiver_tpu_torch.check_leak",
        description="Repeated sample, lookup, train and serve cycles must "
                    "not grow memory, threads or the kernel set.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the phases run (default: the card)")
    p.add_argument("--quick", action="store_true",
                   help="fewer cycles a phase (the widths stay)")
    p.add_argument("--phase", type=int, nargs="+",
                   choices=sorted(PHASES), metavar="N",
                   help="run these phases only (1-16)")
    args = p.parse_args(argv)
    try:
        w = make_world(args.device, quick=args.quick)
    except RuntimeError as e:
        print(f"check_leak: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        recs = run(w, args.phase)
    except LeakError as e:
        print(f"check_leak: LEAK: {e}", file=sys.stderr)
        return 1
    print(f"check_leak: no leak in {len(recs)} phases "
          f"({time.perf_counter() - t0:.1f} s) on {w.card}")
    return 0


if __name__ == "__main__":
    # run through the package's module, so the spawned ranks find this
    # module's functions by their package name
    from quiver_tpu_torch import check_leak as _module
    sys.exit(_module.main())
