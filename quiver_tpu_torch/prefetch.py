"""Frontier-ahead asynchronous cold-tier (disk) prefetch (counterpart of
``quiver_tpu/prefetch.py``).

The feature store places rows by bandwidth: the hot tier on the card,
the host tier in pinned memory, the disk tier in an mmap'd file
(``Feature.set_mmap_file``). This module overlaps the disk tier's reads
with the previous step's compute, keyed on the sampled frontier:

- the sampler side runs one batch ahead (``async_sampler.sample_ahead``,
  or a loop that samples batch i+1 before it looks up batch i) and
  publishes each batch's frontier ids (``Feature.stage_frontier``);
- a prefetcher thread (:class:`ColdPrefetcher`, on a bounded
  ``Pipeline``) translates the frontier through the store's
  ``feature_order``, keeps the disk-tier rows, deduplicates them
  (``ops.dedup.unique_np``), reads them as coalesced extents at queue
  depth ``io_qd`` (``io.ExtentReader``: ``O_DIRECT`` where the file
  system allows it, buffered ``preadv`` elsewhere, the mmap as the
  compat path), and stages them in a fixed-capacity ring
  (:class:`StagingRing`);
- the lookup (``Feature.__getitem__``) reads the rows that hit the ring
  and reads the misses synchronously, counted
  (``metrics.PREFETCH_SYNC_ROWS``), never wrong. A prefetcher that
  falls behind drops publications (``Pipeline.try_submit``) rather than
  hold the sampler back.

**The ring on the card.** The ring's rows lie in pinned host memory (a
plain CPU tensor when the store lives on the CPU). A lookup on the card
maps its cold disk rows to ring slots under the ring's lock (-1 for a
miss and at every other position) and launches one
``ops.kernels.gather.gather_rows`` over the ring with ``out=`` the
lookup's output, so the hit rows land in their final positions, read by
the card over PCIe. The kernel runs after the lock is released, so a
staging worker that wraps around could overwrite slots a queued gather
has not read yet (the JAX package copies the rows out under the lock
and has no such hazard). The lookup therefore records a CUDA event on
the gather's stream, the slots' fence, and a worker about to overwrite
a slot first waits, on its own thread, for the fences of the lookups
that read it. On the CPU the plain gather runs under the lock.

**The ring's layout.** With ``decode_staged=True`` (the default) the
ring holds decoded rows in the tier's logical dtype and the workers
decode int8 in numpy. With ``decode_staged=False`` an int8 ring holds
packed rows (``quant.pack``: codes, fp32 scale and zero in one row) and
the gather decodes them as it reads. Both round the multiply and then
the add (``quant.decode_np``; ``__fmul_rn`` then ``__fadd_rn`` in the
kernel), the bits of the synchronous read.

**Publishing from the card.** ``publish`` copies card ids into pinned
host memory without blocking and records an event on the ids' stream;
the prefetcher thread waits for that event before it reads them. The
staging workers otherwise make no torch call: numpy, ``preadv`` and the
deduplication release the interpreter lock, so they do not compete with
the thread that drives the card.

Boundedness is structural: the ring is preallocated (capacity times the
row width, plus a 4-byte slot index per disk row), the pipeline depth
bounds the staging work in flight, and eviction is wrap-around.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref

import numpy as np
import torch

from . import faults
from .io import coalescing_factor
from .ops import quant
from .ops.dedup import unique_np
from .ops.kernels.gather import gather_rows

_log = logging.getLogger("quiver_tpu_torch.prefetch")


def evict_file_cache(path: str, mapped=None) -> bool:
    """Drop ``path``'s pages from the OS page cache (best effort,
    unprivileged), so that the next reads hit storage and not memory.

    ``mapped`` is the live ``np.memmap`` over ``path``, if any:
    ``fadvise(DONTNEED)`` skips pages still referenced by a mapping's
    page tables, so the mapping's pages are dropped first
    (``madvise(MADV_DONTNEED)``; the next access faults them in again).
    Dirty pages survive DONTNEED too, so the file is fsync'd first.
    Returns False where the platform lacks ``posix_fadvise``; on tmpfs
    the call succeeds and drops nothing (the file is its pages)."""
    import mmap as _mmap
    import os
    if not hasattr(os, "posix_fadvise"):
        return False
    if mapped is not None:
        base = getattr(mapped, "_mmap", None)
        if base is not None and hasattr(base, "madvise"):
            base.madvise(_mmap.MADV_DONTNEED)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return True


class StagingRing:
    """Fixed-capacity staging ring for disk-tier rows.

    ``capacity`` row slots assigned wrap-around (staging past capacity
    overwrites the oldest slots); a ``[total_rows]`` int32 ``slot_of``
    index maps disk row -> slot (-1 = absent). ``table`` is what the row
    gather reads: ``[capacity, dim]`` of ``dtype``, or with
    ``sidecar_dtype`` an int8 ``QuantizedTensor`` (packed rows when the
    sidecars are fp32). It lies in pinned memory when ``device`` is a
    card. ``rows`` (and ``scale``/``zero``) are numpy views of it, which
    the staging workers write.

    One lock guards the index. Writers (:meth:`stage`) also take a
    second lock, so that concurrent workers write one at a time: a
    writer unmaps the slots it takes, waits outside the index lock for
    the fences over them (see the module doc), writes the rows, then
    maps them. A lookup never sees a slot that is being written.
    """

    def __init__(self, capacity: int, dim: int, dtype, total_rows: int,
                 sidecar_dtype=None, device=torch.device("cpu")):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        pin = device.type == "cuda"
        side = None if sidecar_dtype is None else np.dtype(sidecar_dtype)
        if side is None:
            self.table = torch.empty((self.capacity, dim),
                                     dtype=quant.torch_dtype(dtype),
                                     pin_memory=pin)
        else:
            side_t = quant.torch_dtype(side)
            empty = quant.QuantizedTensor(
                torch.zeros((self.capacity, dim), dtype=torch.int8),
                *(torch.zeros((self.capacity, 1), dtype=side_t)
                  for _ in range(2)))
            self.table = quant.pack(empty, pin=pin) \
                if side == np.float32 else quant.tree_map_tier(
                    lambda t: t.pin_memory() if pin else t, empty)
        data, scale, zero = quant.tier_parts(self.table)
        self.rows = data.numpy()
        self.scale = None if scale is None else scale.numpy()
        self.zero = None if zero is None else zero.numpy()
        self.ids = np.full(self.capacity, -1, np.int64)
        self._slot_of = np.full(int(total_rows), -1, np.int32)
        self._cursor = 0
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        # the fences: the last lookup that read each slot, and the CUDA
        # events of the lookups whose gathers may still be running
        self._reader = np.zeros(self.capacity, np.int64)
        self._fences: dict = {}
        self._reads = 0

    @property
    def filled(self) -> int:
        """Occupied slots (bounded by ``capacity`` by construction)."""
        return int((self.ids >= 0).sum())

    def missing(self, ids: np.ndarray) -> np.ndarray:
        """The subset of (unique) ``ids`` not currently staged. Advisory
        under concurrent stagers: :meth:`stage` checks again."""
        with self._lock:
            return ids[self._slot_of[ids] < 0]

    def stage(self, ids: np.ndarray, rows: np.ndarray, scale=None,
              zero=None) -> int:
        """Stage ``rows`` (one per id) into the next slots, evicting
        whatever the wrap lands on. ``ids`` must be unique and at most
        ``capacity`` long (truncate before staging); ids already staged
        are skipped. Returns the rows actually staged."""
        k = int(ids.shape[0])
        if not k:
            return 0
        if k > self.capacity:
            raise ValueError(f"staging {k} rows into a {self.capacity}"
                             "-slot ring (truncate before staging)")
        with self._write_lock:
            with self._lock:
                fresh = self._slot_of[ids] < 0
                if not fresh.all():
                    ids = ids[fresh]
                    rows = rows[fresh]
                    if scale is not None:
                        scale = scale[fresh]
                        zero = zero[fresh]
                    k = int(ids.shape[0])
                    if not k:
                        return 0
                start = self._cursor
                slots = (start + np.arange(k)) % self.capacity
                evicted = self.ids[slots]
                self._slot_of[evicted[evicted >= 0]] = -1
                self.ids[slots] = -1
                self._cursor = int((start + k) % self.capacity)
                fences = [self._fences[s]
                          for s in np.unique(self._reader[slots])
                          if s in self._fences]
            for ev in fences:
                ev.synchronize()
            # the slots are two ranges at most: slice copies, not a
            # fancy-indexed write
            head = min(k, self.capacity - start)
            for dst, src in ((self.rows, rows), (self.scale, scale),
                             (self.zero, zero)):
                if dst is not None:
                    dst[start:start + head] = src[:head]
                    dst[:k - head] = src[head:]
            with self._lock:
                self.ids[slots] = ids
                self._slot_of[ids] = slots.astype(np.int32)
        return k

    def gather_into(self, ids: np.ndarray, pos: np.ndarray,
                    out: torch.Tensor) -> np.ndarray:
        """Write the staged rows of ``ids`` (disk rows, duplicates fine)
        into ``out[pos]``; returns the ``[len(ids)]`` hit mask. One
        ``gather_rows`` over the ring with -1 at every position of
        ``out`` that is not a hit; on the card it is fenced (see the
        module doc), on the CPU it runs under the lock."""
        with self._lock:
            slots = self._slot_of[ids]
            hit = slots >= 0
            if not hit.any():
                return hit
            full = np.full(out.shape[0], -1, np.int32)
            full[pos[hit]] = slots[hit]
            slot_t = torch.from_numpy(full).to(out.device)
            if quant.tier_dtype(self.table) == out.dtype:
                gather_rows(self.table, slot_t, out=out)
            else:
                at = torch.from_numpy(pos[hit]).to(out.device)
                out.index_copy_(0, at, gather_rows(
                    self.table, slot_t.index_select(0, at)).to(out.dtype))
            if out.device.type == "cuda":
                self._fence(out.device, slots[hit])
        return hit

    def _fence(self, device, slots: np.ndarray) -> None:
        """Record the fence of one lookup's gather over ``slots``
        (under the lock), and forget the fences that have passed."""
        self._reads += 1
        self._reader[slots] = self._reads
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        for s in [s for s, e in self._fences.items() if e.query()]:
            del self._fences[s]
        self._fences[self._reads] = ev


class ColdPrefetcher:
    """Frontier-keyed asynchronous reader for a ``Feature``'s disk tier
    (see the module doc).

    Attach with ``Feature.enable_cold_prefetch(capacity_rows)``; publish
    future batches' frontier ids with ``Feature.stage_frontier(ids)``
    (or let ``async_sampler.sample_ahead`` do it); lookups then read the
    ring. Thread-safe; ``close()`` drains the staging task in flight and
    stops the workers.
    """

    def __init__(self, feature, capacity_rows: int, depth: int = 2,
                 decode_staged: bool = True,
                 wait_inflight: bool = True, workers: int = 1,
                 io_qd: int = 16, io_cap_bytes: int = 1 << 20,
                 io_engine: str = "auto", io_model=None):
        if feature.mmap_array is None or feature.disk_map is None:
            raise ValueError("cold-tier prefetch needs an mmap disk "
                             "tier (call set_mmap_file first)")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        from .pipeline import Pipeline
        self._feature = feature
        mm = feature.mmap_array
        self._quantized = feature.disk_scale is not None
        self._out_dtype = (np.dtype(feature.disk_scale.dtype)
                           if self._quantized else np.dtype(mm.dtype))
        self.decode_staged = bool(decode_staged)
        ring_dtype = (self._out_dtype if self.decode_staged
                      else np.dtype(mm.dtype))
        sidecar_dtype = (feature.disk_scale.dtype
                         if self._quantized and not self.decode_staged
                         else None)
        if sidecar_dtype is not None and feature.device.type == "cuda" \
                and np.dtype(sidecar_dtype) != np.float32:
            raise ValueError(
                "an int8 ring read on the card needs fp32 sidecars (the "
                f"tier's are {np.dtype(sidecar_dtype)}); stage decoded "
                "rows (decode_staged=True)")
        self._ring = StagingRing(capacity_rows, mm.shape[1], ring_dtype,
                                 mm.shape[0], sidecar_dtype,
                                 device=feature.device)
        self._pipe = Pipeline(depth=depth, name="quiver-cold-prefetch")
        # the parallel-IO read path (io.py): coalesced extents at queue
        # depth io_qd; None when the tier is not a plain file region (or
        # io_engine="mmap"), and the mmap fancy-index reads instead
        self.workers = int(workers)
        self._reader = None
        if io_engine != "mmap":
            from .io import ExtentReader
            self._reader = ExtentReader.from_array(
                mm, qd=io_qd, io_cap_bytes=io_cap_bytes,
                engine=io_engine, model=io_model)
        # N staging workers shard a publication's unique rows and feed
        # the one ring; the pool exists only past workers=1
        self._stagers = None
        if self.workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="qt-stager")
            self._stagers = pool
            self._stagers_finalizer = weakref.finalize(
                self, pool.shutdown, wait=False)
        # cumulative [hit rows, sync rows, staged rows]
        self._counters = np.zeros(3, np.int64)
        self._staged_undrained = 0
        self._published = 0
        self._dropped = 0
        self._batches_staged = 0
        # frontier rows dropped because one publication exceeded the
        # whole ring: counted, and logged once
        self._truncated = 0
        self._warned_truncate = False
        # IO facts [extents, rows read, bytes, depth peak, read retries,
        # staging-worker restarts] since the last drain and in total
        self._io_undrained = np.zeros(6, np.int64)
        self._io_total = np.zeros(6, np.int64)
        # wait_inflight: a lookup that misses while a staging task is
        # still running waits for it and reads the ring again, instead
        # of reading rows whose read is already in flight a second time
        self.wait_inflight = bool(wait_inflight)
        self._inflight: list = []
        self._hub_last = np.zeros(7, np.int64)
        self._hub_t = None
        self._lock = threading.Lock()

    # -- publishing ---------------------------------------------------------
    def publish(self, frontier_ids, block: bool = False):
        """Publish a future batch's frontier (node ids; -1 padding fine).
        Card ids are copied to pinned host memory without blocking, and
        the worker waits for the copy's event. Returns the staging
        ``Future``, or None when the pipeline is at depth and ``block``
        is False: the publication is dropped (counted; the batch's reads
        fall back to the synchronous path, never wrong)."""
        snap = _snapshot(frontier_ids)
        with self._lock:
            self._published += 1
        if block:
            fut = self._pipe.submit(self._stage, snap)
        else:
            fut = self._pipe.try_submit(self._stage, snap)
        if fut is None:
            with self._lock:
                self._dropped += 1
        else:
            with self._lock:
                self._inflight = [f for f in self._inflight
                                  if not f.done()] + [fut]
        return fut

    def _stage(self, snap) -> int:
        """Worker-side staging: frontier -> storage rows -> disk rows ->
        dedup -> read the rows not staged yet -> ring."""
        ids, ready = snap
        if ready is not None:
            ready.synchronize()
        f = self._feature
        ids = (ids.numpy() if torch.is_tensor(ids) else np.asarray(ids)) \
            .astype(np.int64, copy=False).ravel()
        n_logical = f.size(0)
        valid = (ids >= 0) & (ids < n_logical)
        order = f._order_host()
        t = ids[valid]
        if order is not None:
            # clipped as the synchronous lookup clips: a disk_map may
            # span more rows than the order (size(0) is the map's length)
            t = order[np.clip(t, 0, order.shape[0] - 1)]
        cold = t >= f.cache_rows
        disk_rows = f.disk_map[t[cold]]
        uniq = unique_np(disk_rows)
        new = self._ring.missing(uniq)
        if new.shape[0] > self._ring.capacity:
            # a frontier wider than the whole ring: stage its first
            # capacity rows (staging more would evict rows staged moments
            # earlier in this call); counted, and logged once
            dropped = int(new.shape[0]) - self._ring.capacity
            new = new[: self._ring.capacity]
            with self._lock:
                self._truncated += dropped
                warn = not self._warned_truncate
                self._warned_truncate = True
            if warn:
                _log.warning(
                    "cold-prefetch frontier wider than the staging ring "
                    "(%d unique rows > %d slots): %d rows dropped this "
                    "publication; counted in stats()['truncated_rows'] "
                    "(this warning fires once: grow capacity_rows to "
                    "cover the frontier)", int(uniq.shape[0]),
                    self._ring.capacity, dropped)
        if not new.shape[0]:
            return 0
        # `new` is sorted: contiguous shards keep adjacent rows together,
        # so sharding splits a coalescible extent only at the w-1 seams
        w = min(self.workers, int(new.shape[0]))
        if w > 1 and self._stagers is not None:
            staged = 0
            pending = []
            for shard in np.array_split(new, w):
                fut = self._submit_shard(shard)
                if fut is None:          # no pool left: stage inline
                    staged += self._stage_shard(shard)
                else:
                    pending.append((fut, shard))
            for fut, shard in pending:
                try:
                    staged += fut.result()
                except Exception:
                    # a staging worker died on this shard (an injected
                    # ``prefetch.stager`` fault, a read past the IO
                    # ladder): count the restart and retry the shard once
                    # inline; a second failure fails the publication's
                    # future (the batch's reads then go synchronous)
                    self._count_stager_restart()
                    staged += self._stage_shard(shard)
        else:
            staged = self._stage_shard(new)
        with self._lock:
            self._batches_staged += 1
        return staged

    def _submit_shard(self, shard):
        """Submit one shard to the staging pool, replacing a broken or
        shut-down pool once (counted in ``staging_worker_restarts``).
        None when no usable pool remains: the caller stages inline."""
        for retry in (False, True):
            stagers = self._stagers  # one read: close() may null it
            if stagers is None:
                return None
            try:
                return stagers.submit(self._stage_shard, shard)
            except RuntimeError:
                if self.closed or retry:
                    return None
                self._replace_stagers(stagers)
        return None

    def _replace_stagers(self, observed) -> None:
        """Swap the dead staging pool for a fresh one (counted), only if
        it is still the pool the caller saw failing: of two stagers that
        hit the same dead pool, the second must not replace the first's
        replacement."""
        from concurrent.futures import ThreadPoolExecutor
        with self._lock:
            if self._stagers is not observed or self.closed:
                return
            old_fin = self._stagers_finalizer
            pool = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="qt-stager")
            self._stagers = pool
            self._stagers_finalizer = weakref.finalize(
                self, pool.shutdown, wait=False)
            for vec in (self._io_undrained, self._io_total):
                vec[5] += 1
        old_fin.detach()
        observed.shutdown(wait=False)

    def _count_stager_restart(self) -> None:
        with self._lock:
            for vec in (self._io_undrained, self._io_total):
                vec[5] += 1

    def _stage_shard(self, new: np.ndarray) -> int:
        """Read, decode and stage one shard of a publication's unique
        disk rows: through the ``ExtentReader`` when the tier is a plain
        file region, else the mmap fancy-index."""
        faults.fire("prefetch.stager")
        f = self._feature
        reader = self._reader        # one read: close() may null it
        rows = None
        if reader is not None and not reader.closed:
            try:
                rows, io = reader.read_rows(new)
            except RuntimeError:
                # close(wait=False) shut the reader under a running
                # staging task: the mmap read below is still exact
                rows = None
            else:
                with self._lock:
                    for vec in (self._io_undrained, self._io_total):
                        vec[0] += io["extents"]
                        vec[1] += io["rows"]
                        vec[2] += io["bytes"]
                        vec[3] = max(vec[3], io["depth_peak"])
                        vec[4] += io.get("retries", 0)
        if rows is None:
            rows = np.asarray(f.mmap_array[new])
        scale = zero = None
        if self._quantized:
            scale = np.asarray(f.disk_scale[new])
            zero = np.asarray(f.disk_zero[new])
            if self.decode_staged:
                rows = quant.decode_np(rows, scale, zero)
                scale = zero = None
        staged = self._ring.stage(new, rows, scale, zero)
        with self._lock:
            self._counters[2] += staged
            self._staged_undrained += staged
        return staged

    # -- the lookup-side read -----------------------------------------------
    def gather(self, disk_rows: np.ndarray, pos: np.ndarray,
               out: torch.Tensor, sync_read) -> np.ndarray:
        """Write the rows of ``disk_rows`` (duplicates fine) into
        ``out[pos]``: from the ring where staged; a miss while a staging
        task is still in flight waits for that task and reads the ring
        again; what still misses is read by ``sync_read(rows)`` (a CPU
        tensor of decoded rows) and copied in. Hit and sync row counts
        accumulate (a waited-for row counts as a hit). Returns the hit
        mask."""
        ring = self._ring
        hit = ring.gather_into(disk_rows, pos, out)
        if self.wait_inflight and not hit.all():
            # one snapshot of the stagings in flight at miss time (at
            # most pipeline-depth futures; later publications are not
            # waited on)
            with self._lock:
                pending = [f for f in self._inflight if not f.done()]
                self._inflight = pending
            if pending:
                # the pipeline worker may have died with these futures
                # queued, and this thread is about to block on them
                self._pipe.ensure_worker()
            for fut in pending:
                if hit.all():
                    break
                try:
                    # bounded: a wedged staging task degrades to the
                    # synchronous read below, never a deadlock
                    fut.result(timeout=30.0)
                except Exception:
                    continue
                miss = np.flatnonzero(~hit)
                sub = ring.gather_into(disk_rows[miss], pos[miss], out)
                hit = hit.copy()
                hit[miss[sub]] = True
        with self._lock:
            n_hit = int(hit.sum())
            self._counters[0] += n_hit
            self._counters[1] += int(hit.shape[0]) - n_hit
        miss = ~hit
        if miss.any():
            rows = sync_read(disk_rows[miss])
            out.index_copy_(0, torch.from_numpy(pos[miss]).to(out.device),
                            rows.to(out.device, out.dtype))
        return hit

    # -- telemetry ----------------------------------------------------------
    def counters(self) -> np.ndarray:
        """Cumulative ``[hit_rows, sync_rows, staged_rows]`` (an int64
        copy): the metered lookup reads it around a lookup."""
        with self._lock:
            return self._counters.copy()

    def observe_into(self, hub) -> dict:
        """Feed a telemetry hub (any object with ``observe(name,
        value)``) the deltas since the last call: ``prefetch_hit_rate``,
        ``prefetch_staged_rows``, ``cold_staged_rows_per_s``,
        ``prefetch_truncated_rows``, ``prefetch_drop_rate`` and
        ``staging_worker_restarts``, each where it has a value, as the
        JAX package's ``observe_into`` does. Returns the delta dict."""
        t_now = time.monotonic()
        with self._lock:
            now = np.array([*(int(v) for v in self._counters),
                            self._published, self._dropped,
                            self._truncated,
                            int(self._io_total[5])], np.int64)
            d = now - self._hub_last
            self._hub_last = now
            dt, self._hub_t = (None if self._hub_t is None
                               else t_now - self._hub_t), t_now
        hit, sync, staged, pub, drop, trunc, restarts = \
            (int(v) for v in d)
        out = {"hit_rows": hit, "sync_rows": sync, "staged_rows": staged,
               "published": pub, "dropped": drop,
               "truncated_rows": trunc,
               "staging_worker_restarts": restarts}
        if hit + sync:
            hub.observe("prefetch_hit_rate", hit / (hit + sync))
        hub.observe("prefetch_staged_rows", staged)
        if dt is not None and dt > 0:
            out["staged_rows_per_s"] = staged / dt
            hub.observe("cold_staged_rows_per_s", staged / dt)
        if trunc:
            hub.observe("prefetch_truncated_rows", trunc)
        if pub:
            hub.observe("prefetch_drop_rate", drop / pub)
        if restarts:
            hub.observe("staging_worker_restarts", restarts)
        return out

    def drain_staged(self) -> int:
        """Rows staged since the last drain: a batch's publication runs
        during the previous step, so the metered lookup counts what was
        staged since the last one (``PREFETCH_STAGED_ROWS``)."""
        with self._lock:
            staged, self._staged_undrained = self._staged_undrained, 0
        return staged

    def drain_io(self) -> np.ndarray:
        """IO facts since the last drain, ``[extents, rows_read, bytes,
        depth_peak, retries, stager_restarts]`` int64, for the metered
        lookup's IO slots (the peak resets each drain)."""
        with self._lock:
            vals = self._io_undrained.copy()
            self._io_undrained[:] = 0
        return vals

    def stats(self) -> dict:
        """Publication and row counts, the hit rate, ring occupancy,
        truncation, the IO facts (engine, extents, coalescing factor,
        bytes, depth peak) and the staging pipeline's stats."""
        with self._lock:
            hit, sync, staged = (int(v) for v in self._counters)
            pub, drop, bat, trunc = (self._published, self._dropped,
                                     self._batches_staged,
                                     self._truncated)
            (io_ext, io_rows, io_bytes, io_peak, io_retries,
             restarts) = (int(v) for v in self._io_total)
        total = hit + sync
        return {
            "published": pub, "dropped": drop, "batches_staged": bat,
            "hit_rows": hit, "sync_rows": sync, "staged_rows": staged,
            "truncated_rows": trunc,
            "hit_rate": (hit / total) if total else None,
            "capacity": self._ring.capacity, "filled": self._ring.filled,
            "workers": self.workers,
            "staging_worker_restarts": restarts,
            "io": {
                "engine": (self._reader.engine
                           if self._reader is not None else "mmap"),
                "extents": io_ext, "rows_read": io_rows,
                "bytes_read": io_bytes, "depth_peak": io_peak,
                "retries": io_retries,
                "coalescing_factor": coalescing_factor(io_rows, io_ext),
            },
            "pipeline": self._pipe.stats(),
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self, wait: bool = True):
        """Stop the staging machinery (idempotent): queued publications
        are cancelled, the one in flight finishes, the pipeline worker is
        joined (``wait=True``), then the staging pool and the extent
        reader's threads stop."""
        self._pipe.close(wait=wait)
        pool, self._stagers = self._stagers, None
        if pool is not None:
            self._stagers_finalizer.detach()
            pool.shutdown(wait=wait)
        reader, self._reader = self._reader, None
        if reader is not None:
            reader.close(wait=wait)

    @property
    def closed(self) -> bool:
        return self._pipe.closed

    def __enter__(self) -> "ColdPrefetcher":
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        s = self.stats()
        return (f"ColdPrefetcher(capacity={s['capacity']}, "
                f"filled={s['filled']}, hit={s['hit_rows']}, "
                f"sync={s['sync_rows']}, "
                f"{'closed' if self.closed else 'open'})")


def _snapshot(ids):
    """``(host ids, event)``: a copy the caller cannot change under the
    worker. Card ids go to pinned memory without blocking, with the
    event the worker waits for (recorded on the ids' device's stream);
    host ids are copied, with no event."""
    if torch.is_tensor(ids):
        if ids.device.type == "cuda":
            host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            host.copy_(ids, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(ids.device))
            return host, ready
        return ids.detach().clone(), None
    return np.array(ids, copy=True), None
