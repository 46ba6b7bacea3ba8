"""Parallel-IO cold-tier reads: coalesced extents at deep queue depth
(the port's own copy of ``quiver_tpu/io.py``; stdlib and numpy only).

A disk tier read one row at a time (``np.asarray(mmap[rows])``) takes a
page fault per row at queue depth 1: the storage device serves a
fraction of its bandwidth because the host never gives it more than one
outstanding request. This module reads the way the
GPU-initiated-direct-storage work (2306.16384) and FastSample's
locality-aware batching (2311.17847) do, on the host:

1. **extent planning** (:func:`plan_extents`): the deduplicated disk
   rows are sorted; adjacent rows coalesce into one ``(start_row,
   n_rows)`` extent (one request instead of n, sequential on the
   device); an extent past an IO-size cap splits, so that one long run
   cannot hold the queue behind it;
2. **deep-queue issue** (:class:`ExtentReader`): the extents go to a
   pool of reader threads, each issuing positioned ``os.preadv`` reads
   straight into the output array, so the device sees up to ``qd``
   requests in flight instead of one. Where the file system allows it,
   the file is opened ``O_DIRECT`` (the page cache bypassed: the tier
   exists for data that does not fit in RAM) with block-aligned scratch
   buffers (:func:`align_extent`); elsewhere the buffered ``preadv``
   path applies (tmpfs and overlayfs refuse ``O_DIRECT`` reads), and the
   plain mmap fancy-index stays the compat path for arrays that are not
   file-backed.

Everything here runs on the host; the rows it returns are the bytes of
``mmap[rows]``, bit for bit (``tests/test_torch_io.py`` holds it to the
JAX package's reader).

:class:`StorageModel` is a deterministic queue-depth device model for
tests and benchmarks: each request costs a fixed service time and at
most ``qd`` requests overlap (``time.sleep`` releases the GIL, so the
overlap is real). A serial issuer pays queue-depth-1 service per
request; the reader pool overlaps up to ``qd``.
"""

from __future__ import annotations

import errno as _errno
import mmap as _mmap
import os
import threading
import time as _time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from . import faults

#: O_DIRECT alignment: offsets, lengths and buffer addresses must be
#: multiples of the logical block size; 4096 satisfies every common
#: device (512-sector disks accept it too).
DIRECT_ALIGNMENT = 4096

#: default per-request IO size cap (bytes): extents larger than this
#: split, so one long coalesced run cannot serialize the whole queue
#: behind a single request.
DEFAULT_IO_CAP_BYTES = 1 << 20

#: transient read errors worth retrying before falling back: an
#: interrupted syscall, a momentarily unready device, a one-off media
#: error the next attempt may not see.
TRANSIENT_ERRNOS = (_errno.EINTR, _errno.EAGAIN, _errno.EIO)

#: per-extent retry budget (attempts beyond the first) and the base of
#: the exponential backoff between them.
IO_READ_RETRIES = 3
IO_RETRY_BACKOFF_S = 0.001


# -- pure extent math (host, tested exhaustively) ---------------------------


def plan_extents(rows: np.ndarray, row_bytes: int,
                 io_cap_bytes: int = DEFAULT_IO_CAP_BYTES) -> np.ndarray:
    """Coalesce sorted unique ``rows`` into ``[k, 2]`` ``(start_row,
    n_rows)`` extents: maximal runs of adjacent row ids merge into one
    extent; extents wider than ``io_cap_bytes`` split into cap-sized
    requests. Returns an int64 ``[k, 2]`` array whose ``n_rows`` sum
    equals ``rows.size`` — extent i's rows occupy positions
    ``[sum(n_rows[:i]), sum(n_rows[:i+1]))`` of the input, which is
    what lets the reader scatter each request straight into its output
    slice."""
    rows = np.asarray(rows, np.int64).ravel()
    if rows.size == 0:
        return np.empty((0, 2), np.int64)
    if rows.size > 1 and not (np.diff(rows) > 0).all():
        raise ValueError("plan_extents needs sorted unique rows")
    cap_rows = max(int(io_cap_bytes) // max(int(row_bytes), 1), 1)
    breaks = np.flatnonzero(np.diff(rows) != 1) + 1
    starts = np.concatenate([[0], breaks])
    ends = np.concatenate([breaks, [rows.size]])
    out = []
    for s, e in zip(starts, ends):
        start, count = int(rows[s]), int(e - s)
        while count > cap_rows:
            out.append((start, cap_rows))
            start += cap_rows
            count -= cap_rows
        out.append((start, count))
    return np.asarray(out, np.int64).reshape(-1, 2)


def align_extent(offset: int, length: int,
                 alignment: int = DIRECT_ALIGNMENT
                 ) -> Tuple[int, int, int]:
    """Round a byte extent outward to ``alignment`` (the O_DIRECT
    contract: offset AND length must be block multiples). Returns
    ``(aligned_offset, aligned_length, head)`` where ``head`` is how
    many leading bytes of the aligned read precede the requested
    offset — the payload is ``buf[head : head + length]``."""
    if alignment < 1:
        raise ValueError(f"alignment must be >= 1, got {alignment}")
    a_off = offset - offset % alignment
    head = offset - a_off
    need = head + length
    a_len = ((need + alignment - 1) // alignment) * alignment
    return a_off, a_len, head


def coalescing_factor(rows: int, extents: int) -> Optional[float]:
    """Rows moved per request — the lever coalescing pulls (1.0 means
    every row cost its own request; None when nothing was read)."""
    return (rows / extents) if extents else None


# -- the deterministic queue-depth device model (tests and benchmarks) ------


class StorageModel:
    """Deterministic queue-depth storage-device model: every request
    costs ``service_us`` of device time (plus ``bytes/bandwidth`` when
    ``bw_mbps`` is set) and the device completes at most ``qd``
    requests concurrently.

    Two issue disciplines, matching the two read paths:

    - :meth:`request` — a SERIAL issuer (the per-row mmap-fault
      path): ``n`` back-to-back requests cost their full combined
      service time, queue depth 1 by construction, charged as one
      ``time.sleep`` (sleep releases the GIL, so whatever a prefetch
      thread overlaps against compute is honest).
    - :meth:`request_deep` — a DEEP-QUEUE issuer (the extent reader):
      ``n`` requests in flight together drain at the device's
      ``qd``-way rate. Modeled as a fluid queue against a SHARED
      virtual device clock: the clock advances ``n * service / qd``
      per call (concurrent callers share it, so aggregate throughput
      never exceeds the device's), and the caller sleeps once until
      its drain deadline plus one service time of fill latency. One
      sleep per call — per-request sleeps would drown the model in
      timer granularity (~1 ms on a stock kernel vs 10s-of-us service
      times), and because the clock only ever advances by modeled
      cost from ``max(now, clock)``, sleep overshoot never compounds.

    Unlike a page-cached or virtualised disk, whose service time varies
    from run to run, the model's arithmetic is the same every run.
    """

    def __init__(self, service_us: float, qd: int = 1,
                 bw_mbps: float = 0.0):
        if qd < 1:
            raise ValueError(f"modeled queue depth must be >= 1, got {qd}")
        self.service_us = float(service_us)
        self.qd = int(qd)
        self.bw_mbps = float(bw_mbps)
        self._lock = threading.Lock()
        self._vclock = 0.0
        self.requests = 0
        self.busy_s = 0.0

    def _cost_s(self, nbytes: int) -> float:
        c = self.service_us * 1e-6
        if self.bw_mbps:
            c += nbytes / (self.bw_mbps * 1e6)
        return c

    def request(self, nbytes: int = 0, n: int = 1) -> None:
        """Charge ``n`` back-to-back requests from ONE serial issuer
        (their combined service time, no overlap — a serial issuer
        cannot overlap with itself, no matter the device's qd)."""
        import time
        cost = self._cost_s(nbytes) * int(n)
        time.sleep(cost)
        with self._lock:
            self.requests += int(n)
            self.busy_s += cost

    def request_deep(self, n: int, nbytes: int = 0) -> None:
        """Charge ``n`` requests issued at full depth (see class doc:
        shared virtual clock, ``qd``-way drain rate, one sleep)."""
        import time
        if n < 1:
            return
        device_s = self._cost_s(nbytes) * int(n) / self.qd
        now = time.perf_counter()
        with self._lock:
            self._vclock = max(self._vclock, now) + device_s
            deadline = self._vclock
            self.requests += int(n)
            self.busy_s += device_s
        time.sleep(max(0.0, deadline + self._cost_s(0) - now))


# -- the reader -------------------------------------------------------------


def _cleanup_reader(pool, fds):
    """GC safety net (bound to the resources, never the reader): stop
    the pool without joining (this may run from the GC) and close the
    file descriptors."""
    pool.shutdown(wait=False)
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            pass


class ExtentReader:
    """Deep-queue batched row reader over one ``[rows, dim]`` binary
    file region (an ``.npy`` data segment: ``base_offset`` bytes of
    header, then C-contiguous ``dtype`` rows).

    ``read_rows(sorted_rows)`` plans extents (:func:`plan_extents`),
    fans them out to ``qd`` reader threads, and assembles the rows into
    one ``[n, dim]`` array of the storage dtype — buffered ``preadv``
    lands each extent straight in its output slice (zero copy);
    ``O_DIRECT`` reads go through a per-thread page-aligned scratch
    buffer (:func:`align_extent`) and memcpy the payload out. Engines:

    - ``"auto"``: probe ``O_DIRECT`` at construction, keep it if one
      aligned read succeeds, else buffered preadv;
    - ``"direct"`` / ``"pread"``: force one path (``"direct"`` still
      falls back per-extent if the kernel rejects a read mid-run);
    - the caller holds the mmap compat fallback for non-file arrays
      (see ``from_array`` returning None).

    ``model`` (a :class:`StorageModel`) is the test hook: the model
    then provides ALL the timing — one ``request_deep`` charge per
    ``read_rows`` batch (extent count at the modeled queue depth) —
    and the bytes come from the cheapest exact read available (a
    memmap gather of the same file region; bit-identity is
    non-negotiable). The thread pool is deliberately NOT used under a
    model: on a page-cached file, real parallel preads measure GIL
    contention, not storage — the model's arithmetic is the device,
    and it is the same on every run. ``depth_peak`` then reports the depth the
    model granted, ``min(qd, extents)``.

    Lifecycle: ``close()`` is idempotent and joins the pool; a
    ``weakref.finalize`` bound to the pool+fds reaps an abandoned
    reader.
    """

    def __init__(self, path: str, dtype, shape, base_offset: int,
                 qd: int = 16, io_cap_bytes: int = DEFAULT_IO_CAP_BYTES,
                 engine: str = "auto",
                 model: Optional[StorageModel] = None):
        if engine not in ("auto", "direct", "pread"):
            raise ValueError(f"unknown io engine {engine!r}")
        if qd < 1:
            raise ValueError(f"reader queue depth must be >= 1, got {qd}")
        self.path = str(path)
        self.dtype = np.dtype(dtype)
        self.shape = (int(shape[0]), int(shape[1]))
        self.base_offset = int(base_offset)
        self.row_bytes = self.shape[1] * self.dtype.itemsize
        self.qd = int(qd)
        self.io_cap_bytes = int(io_cap_bytes)
        self.model = model
        self._fd = os.open(self.path, os.O_RDONLY)
        self._size = os.fstat(self._fd).st_size
        fds = [self._fd]
        self._direct_fd = None
        self._mm = None
        if model is not None:
            # a modeled device IS the storage: timing comes from the
            # model, bytes from the cheapest exact read (a memmap
            # gather) — real threaded preads on a page-cached file
            # would measure GIL contention, a second device the model
            # exists to replace
            engine = "pread"
            self._mm = np.memmap(self.path, self.dtype, mode="r",
                                 offset=self.base_offset,
                                 shape=self.shape)
        if engine in ("auto", "direct") and hasattr(os, "O_DIRECT"):
            self._direct_fd = self._probe_direct()
            if self._direct_fd is not None:
                fds.append(self._direct_fd)
        if engine == "direct" and self._direct_fd is None:
            os.close(self._fd)
            raise OSError("O_DIRECT unavailable for "
                          f"{self.path} (engine='direct' forced)")
        self.engine = "direct" if self._direct_fd is not None else "pread"
        self._scratch = threading.local()
        pool = ThreadPoolExecutor(max_workers=self.qd,
                                  thread_name_prefix="qt-io-reader")
        self._pool = pool
        self._closed = False
        # in-flight depth accounting: what the DEVICE actually saw
        # (shared across callers; each read_rows carries its own peak)
        self._depth_lock = threading.Lock()
        self._inflight = 0
        self._finalizer = weakref.finalize(self, _cleanup_reader, pool,
                                           tuple(fds))

    @classmethod
    def from_array(cls, arr, **kwargs) -> Optional["ExtentReader"]:
        """Build a reader over a file-backed ``np.memmap`` (or a
        wrapper forwarding ``filename``/``offset``/``dtype``/``shape``
        to one). Returns None when the array is not a whole
        C-contiguous 2-D file region — the caller keeps the mmap
        fancy-index as the compat path. ``engine="direct"`` failures
        PROPAGATE (a forced engine silently degrading to the per-row
        path would report QD1 numbers under a 'direct' label)."""
        filename = getattr(arr, "filename", None)
        offset = getattr(arr, "offset", None)
        if filename is None or offset is None:
            return None
        shape = getattr(arr, "shape", ())
        if len(shape) != 2:
            return None
        flags = getattr(arr, "flags", None)
        if flags is not None and not flags["C_CONTIGUOUS"]:
            return None
        # a VIEW of a memmap (mm[2:]) inherits the parent's .offset
        # while its data starts elsewhere — reading by offset math
        # would return the parent's rows, silently shifted. A whole
        # memmap's .base is the raw mmap buffer; a view's is the
        # parent ndarray.
        if isinstance(getattr(arr, "base", None), np.ndarray):
            return None
        if kwargs.get("engine") == "direct":
            return cls(filename, arr.dtype, shape, offset, **kwargs)
        try:
            return cls(filename, arr.dtype, shape, offset, **kwargs)
        except OSError:
            return None

    # -- O_DIRECT plumbing --------------------------------------------------
    def _probe_direct(self) -> Optional[int]:
        """Open with O_DIRECT and prove one aligned read works (many
        filesystems — overlayfs, tmpfs — accept the open then fail the
        read); any failure means buffered pread."""
        try:
            fd = os.open(self.path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            return None
        try:
            buf = _mmap.mmap(-1, DIRECT_ALIGNMENT)
            got = os.preadv(fd, [buf], 0)
            if got <= 0 and self._size > 0:
                raise OSError("O_DIRECT probe read returned nothing")
            return fd
        except OSError:
            os.close(fd)
            return None

    def _scratch_buf(self, size: int):
        """Per-reader-thread page-aligned scratch (anonymous mmap —
        page-aligned by construction, reused across extents; one
        buffer per pool thread bounds the memory at
        ``qd * (io_cap + 2 pages)``)."""
        buf = getattr(self._scratch, "buf", None)
        if buf is None or len(buf) < size:
            alloc = ((size + DIRECT_ALIGNMENT - 1)
                     // DIRECT_ALIGNMENT) * DIRECT_ALIGNMENT
            buf = _mmap.mmap(-1, alloc)
            self._scratch.buf = buf
        return buf

    # -- the read paths -----------------------------------------------------
    def _pread_into(self, fd: int, view, offset: int) -> int:
        """Positioned read filling ``view`` (retrying short reads);
        returns bytes read — short only at EOF."""
        mv = memoryview(view).cast("B")
        total = 0
        while total < len(mv):
            got = os.preadv(fd, [mv[total:]], offset + total)
            if got <= 0:
                break
            total += got
        return total

    def _read_extent(self, out: np.ndarray, pos: int, start_row: int,
                     n_rows: int, acct: Optional[dict] = None) -> int:
        """Read one extent into ``out[pos : pos + n_rows]`` with the
        resilience ladder: transient errors (``TRANSIENT_ERRNOS`` —
        EINTR/EAGAIN/EIO, including injected ones: the ``io.read``
        fault site fires per attempt) retry up to ``IO_READ_RETRIES``
        times under exponential backoff, then the extent falls back to
        a per-extent mmap read (same bytes, page-fault path); only
        when THAT also fails does the extent raise — loudly, naming
        the extent — so a permanently failing fd surfaces at the
        lookup and never returns short rows. ``acct`` (this call's
        holder) counts ``retries``/``fallback_extents``. Returns the
        bytes the device moved."""
        last: Optional[BaseException] = None
        for attempt in range(1 + IO_READ_RETRIES):
            try:
                faults.fire("io.slow")
                faults.fire("io.read")
                return self._read_extent_once(out, pos, start_row,
                                              n_rows)
            except OSError as e:
                last = e
                if e.errno not in TRANSIENT_ERRNOS:
                    break                # permanent: straight to mmap
                if attempt < IO_READ_RETRIES:
                    if acct is not None:
                        with self._depth_lock:
                            acct["retries"] = acct.get("retries", 0) + 1
                    _time.sleep(IO_RETRY_BACKOFF_S * (2 ** attempt))
        # retries exhausted (or permanent error): per-extent mmap
        # fallback — the compat path reads the same bytes through the
        # page cache, so a flaky fd degrades to QD1 for THIS extent
        # instead of stranding the whole staging future
        try:
            rows = self._fallback_mmap()[start_row:start_row + n_rows]
            out[pos:pos + n_rows] = rows
        except BaseException:
            raise OSError(
                getattr(last, "errno", _errno.EIO) or _errno.EIO,
                f"extent (start_row={start_row}, n_rows={n_rows}) of "
                f"{self.path} failed after {IO_READ_RETRIES} retries "
                f"AND the mmap fallback; last error: {last}") from last
        if acct is not None:
            with self._depth_lock:
                acct["fallback_extents"] = \
                    acct.get("fallback_extents", 0) + 1
        return n_rows * self.row_bytes

    def _fallback_mmap(self) -> np.ndarray:
        """Lazily built per-reader memmap over the same file region —
        the per-extent degraded read path (never the fast path)."""
        mm = self._mm
        if mm is None:
            mm = np.memmap(self.path, self.dtype, mode="r",
                           offset=self.base_offset, shape=self.shape)
            self._mm = mm
        return mm

    def _read_extent_once(self, out: np.ndarray, pos: int,
                          start_row: int, n_rows: int) -> int:
        """One read attempt (no retry): O_DIRECT scratch or buffered
        preadv straight into ``out[pos : pos + n_rows]``."""
        length = n_rows * self.row_bytes
        offset = self.base_offset + start_row * self.row_bytes
        dst = out[pos:pos + n_rows]
        if self._direct_fd is not None:
            a_off, a_len, head = align_extent(offset, length)
            buf = self._scratch_buf(a_len)
            got = self._pread_into(self._direct_fd,
                                   memoryview(buf)[:a_len], a_off)
            if got >= head + length:
                flat = np.frombuffer(buf, np.uint8,
                                     length, head)
                dst.view(np.uint8).reshape(-1)[:] = flat
                return a_len
            # kernel rejected / truncated the direct read (e.g. an
            # unsupported FS past the probe): buffered fallback,
            # still exact
        got = self._pread_into(self._fd, dst, offset)
        if got != length:
            raise OSError(
                f"short read: wanted {length} bytes at {offset} of "
                f"{self.path}, got {got}")
        return length

    def _read_span(self, out: np.ndarray, pos: np.ndarray,
                   extents: np.ndarray, idx: np.ndarray,
                   peak: dict) -> int:
        """One queue slot's work: drain a slice of the extent list
        serially (the slot holds at most one request in flight, so
        depth accounting is per SPAN — two lock takes per extent was
        measurable overhead at thousands of extents/publication).
        ``peak`` is the CALL's own holder: the in-flight count is
        shared (the device sees every caller's requests) but each
        read_rows reports the depth ITS spans observed — a shared
        reset would race under concurrent staging workers; the
        retry/fallback counts ride the same holder."""
        with self._depth_lock:
            self._inflight += 1
            peak["depth"] = max(peak["depth"], self._inflight)
        try:
            moved = 0
            for i in idx:
                moved += self._read_extent(out, int(pos[i]),
                                           int(extents[i, 0]),
                                           int(extents[i, 1]), peak)
            return moved
        finally:
            with self._depth_lock:
                self._inflight -= 1

    def read_rows(self, rows: np.ndarray):
        """Read the (sorted unique) ``rows`` at full queue depth.
        Returns ``(out, stats)``: a ``[n, dim]`` array of the storage
        dtype, bit-identical to ``mmap[rows]``, plus this call's IO
        facts — ``{"extents", "rows", "bytes", "depth_peak",
        "retries", "fallback_extents"}`` — for the metrics slots."""
        if self._closed:
            raise RuntimeError("ExtentReader is closed")
        rows = np.asarray(rows, np.int64).ravel()
        extents = plan_extents(rows, self.row_bytes, self.io_cap_bytes)
        out = np.empty((rows.size, self.shape[1]), self.dtype)
        # this CALL's holder: observed depth + retry/fallback counts
        peak = {"depth": 0, "retries": 0, "fallback_extents": 0}
        moved = 0
        if self.model is not None:
            # modeled device: charge the deep-queue batch, fetch the
            # same bytes through the memmap (see class doc)
            if len(extents):
                self.model.request_deep(len(extents),
                                        rows.size * self.row_bytes)
                out[:] = self._mm[rows]
                moved = rows.size * self.row_bytes
            return out, {"extents": int(len(extents)),
                         "rows": int(rows.size), "bytes": int(moved),
                         "depth_peak": int(min(self.qd, len(extents))),
                         "retries": 0, "fallback_extents": 0}
        if len(extents) == 1:
            # one request: issue inline, no pool round-trip
            moved += self._read_extent(out, 0, int(extents[0, 0]),
                                       int(extents[0, 1]), peak)
            peak["depth"] = max(peak["depth"], 1)
        elif len(extents):
            pos = np.zeros(len(extents), np.int64)
            np.cumsum(extents[:-1, 1], out=pos[1:])
            # one pool task per QUEUE SLOT, not per extent: ``qd``
            # workers each serially draining a slice of the extent
            # list IS a depth-qd queue, and it caps the executor's
            # per-task overhead (~0.1 ms each on a busy host — more
            # than a whole modeled request) at qd futures per read
            # instead of one per extent
            chunks = np.array_split(np.arange(len(extents)),
                                    min(self.qd, len(extents)))
            futs = [self._pool.submit(self._read_span, out, pos,
                                      extents, idx, peak)
                    for idx in chunks if idx.size]
            for f in futs:
                moved += f.result()
        stats = {"extents": int(len(extents)), "rows": int(rows.size),
                 "bytes": int(moved), "depth_peak": int(peak["depth"]),
                 "retries": int(peak["retries"]),
                 "fallback_extents": int(peak["fallback_extents"])}
        return out, stats

    # -- lifecycle ----------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        """Idempotent: stop the reader pool (joined when ``wait``),
        close the descriptors. ``wait=False`` leaves fd closing to the
        pool threads' natural exit via the finalizer — an in-flight
        read must not hit a closed fd."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=wait)
        if not wait:
            return                   # finalizer still owns the fds
        self._finalizer.detach()
        for fd in (self._fd, self._direct_fd):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "ExtentReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return (f"ExtentReader({self.path!r}, engine={self.engine}, "
                f"qd={self.qd}, cap={self.io_cap_bytes}, "
                f"{'closed' if self._closed else 'open'})")
