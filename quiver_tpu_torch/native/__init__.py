"""The native host sampling engine (counterpart of ``quiver_tpu/native``).

``cpu_sampler.cpp`` is the port's own copy of the JAX package's C++
engine. It is built at first use by ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` into ``build/quiver_tpu_torch/`` beside the CUDA kernels,
under a name that carries a hash of the source and the flags, so an
edited source never loads a stale library. The compiler writes a
temporary file that is then ``os.replace``d into place, so builds racing
from several processes or threads leave one whole library. A failed
build raises with the compiler's message: nothing falls back to numpy
quietly (the JAX loader's numpy fallback draws from another stream).
The prebuilt library of the JAX package is never loaded.

The wrappers take and give numpy with the JAX wrappers' shapes: -1
fill, ``with_slots`` (each pick's flat CSR slot, the input of edge-id
lookups), ``num_threads`` (0: one thread per hardware thread, see
:func:`threads_used`) and, in :func:`cpu_sample_multihop`, seed
``seed + li`` on hop ``li``. ``ctypes`` releases the GIL for the call,
so several Python threads sample at once (``MixedGraphSageSampler``).

Beside each wrapper is its plain numpy version (``*_plain``), the same
arithmetic step for step: splitmix64 in ``np.uint64`` keyed by ``(seed,
v)``, the partial Fisher-Yates with its write log, and for the weighted
draw the same float64 uniform ``(z >> 11) * 2**-53 * total`` and CDF
search. The two are equal bit for bit; the tests hold the engine to the
plain versions, and no sampling path runs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from ..ops.kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "cpu_sampler.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


# -- build and load -----------------------------------------------------------


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcpu_sampler_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The engine's library, compiled first if it is not there. Raises
    ``RuntimeError`` naming the failure when ``g++`` is missing or fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            f"g++ not found: the native CPU sampling engine ({SRC.name}) "
            "is built with g++ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded engine, built on the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.qt_abi_v2          # the v2 signatures (with out_slots) or nothing
    p, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                        ctypes.c_uint64)
    lib.qt_sample_layer.argtypes = [p, p, p, i64, i32, u64, p, p, p, i32]
    lib.qt_sample_layer.restype = None
    lib.qt_sample_layer_weighted.argtypes = [p, p, p, p, i64, i32, i32,
                                             u64, p, p, p, i32]
    lib.qt_sample_layer_weighted.restype = None
    lib.qt_reindex.argtypes = [p, i64, p, i32, p, p, p]
    lib.qt_reindex.restype = i64
    lib.qt_hardware_threads.argtypes = []
    lib.qt_hardware_threads.restype = i32
    return lib


def threads_used(num_threads: int, num_seeds: int) -> int:
    """The threads one engine call starts: ``num_threads``, or the
    host's hardware threads when it is 0, capped at the seed count."""
    nt = num_threads if num_threads > 0 \
        else get_lib().qt_hardware_threads()
    return max(1, min(nt, num_seeds))


# -- the wrappers -------------------------------------------------------------


def _ptr(a):
    return None if a is None else a.ctypes.data


def _inputs(indptr, indices, seeds, k: int):
    """The engine's dtypes, contiguous, with the bounds it reads
    unchecked validated here."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    seeds = np.ascontiguousarray(seeds, dtype=np.int32)
    if indptr.ndim != 1 or indptr.shape[0] < 1 or seeds.ndim != 1:
        raise ValueError("indptr and seeds must be 1-D, indptr non-empty")
    if int(k) < 0:
        raise ValueError(f"fanout must be >= 0, got {k}")
    n = indptr.shape[0] - 1
    if seeds.size and int(seeds.max()) >= n:
        raise ValueError(f"seed {int(seeds.max())} out of range for "
                         f"{n} nodes")
    if int(indptr[-1]) > indices.shape[0]:
        raise ValueError(f"indptr ends at {int(indptr[-1])} but indices "
                         f"has {indices.shape[0]} entries")
    return indptr, indices, seeds


def _outputs(s: int, k: int, with_slots: bool):
    return (np.empty((s, k), np.int32), np.empty((s,), np.int32),
            np.empty((s, k), np.int64) if with_slots else None)


def cpu_sample_layer(indptr, indices, seeds, k: int, seed: int = 0,
                     num_threads: int = 0, with_slots: bool = False):
    """Per seed, up to ``k`` distinct uniform neighbours. Returns
    ``(nbrs [s, k] -1 fill, counts [s])``, with ``with_slots`` also each
    pick's flat CSR slot (``[s, k]`` int64, -1 fill)."""
    indptr, indices, seeds = _inputs(indptr, indices, seeds, k)
    s = seeds.shape[0]
    nbrs, counts, slots = _outputs(s, k, with_slots)
    get_lib().qt_sample_layer(
        _ptr(indptr), _ptr(indices), _ptr(seeds), s, k,
        seed & (2**64 - 1), _ptr(nbrs), _ptr(counts), _ptr(slots),
        num_threads)
    return (nbrs, counts, slots) if with_slots else (nbrs, counts)


def cpu_sample_layer_weighted(indptr, indices, weights, seeds, k: int,
                              seed: int = 0, row_cap: int = 2048,
                              num_threads: int = 0,
                              with_slots: bool = False):
    """Per seed, ``min(deg, k)`` draws with replacement, in proportion to
    the (CSR-slot-aligned) edge weight, among the first ``min(deg,
    row_cap)`` neighbours: the device pool draw's contract
    (``ops/weighted.py``). A row of zero mass gives counts 0 and -1
    picks."""
    indptr, indices, seeds = _inputs(indptr, indices, seeds, k)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    if weights.shape != indices.shape:
        raise ValueError(f"weights {weights.shape} must match indices "
                         f"{indices.shape}")
    s = seeds.shape[0]
    nbrs, counts, slots = _outputs(s, k, with_slots)
    get_lib().qt_sample_layer_weighted(
        _ptr(indptr), _ptr(indices), _ptr(weights), _ptr(seeds), s, k,
        row_cap, seed & (2**64 - 1), _ptr(nbrs), _ptr(counts),
        _ptr(slots), num_threads)
    return (nbrs, counts, slots) if with_slots else (nbrs, counts)


def cpu_reindex(seeds, nbrs):
    """First-occurrence compaction of one hop. ``seeds [s]`` (-1 allowed),
    ``nbrs [s, k]`` (-1 fill). Returns ``(n_id [s + s*k] -1 fill, count,
    row [s*k], col [s*k])``: the unique ids, valid seeds first, and the
    hop's COO in local ids (-1 where the edge is masked)."""
    seeds = np.ascontiguousarray(seeds, dtype=np.int32)
    nbrs = np.ascontiguousarray(nbrs, dtype=np.int32)
    s, k = nbrs.shape
    if seeds.shape != (s,):
        raise ValueError(f"seeds {seeds.shape} against nbrs {nbrs.shape}")
    n_id = np.empty((s + s * k,), np.int32)
    row = np.empty((s * k,), np.int32)
    col = np.empty((s * k,), np.int32)
    count = get_lib().qt_reindex(_ptr(seeds), s, _ptr(nbrs), k,
                                 _ptr(n_id), _ptr(row), _ptr(col))
    return n_id, int(count), row, col


def _multihop(layer: Callable, layer_w: Callable, reindex: Callable,
              indptr, indices, seeds, sizes, seed, num_threads, weights,
              row_cap, with_slots):
    cur = np.ascontiguousarray(seeds, dtype=np.int32)
    rows, cols, slot_lists = [], [], []
    for li, k in enumerate(sizes):
        if weights is not None:
            out = layer_w(indptr, indices, weights, cur, k, seed=seed + li,
                          row_cap=row_cap, num_threads=num_threads,
                          with_slots=with_slots)
        else:
            out = layer(indptr, indices, cur, k, seed=seed + li,
                        num_threads=num_threads, with_slots=with_slots)
        n_id, _, row, col = reindex(cur, out[0])
        rows.append(row)
        cols.append(col)
        if with_slots:
            # an edge the reindex masks (its seed is -1) masks its slot
            slot_lists.append(np.where(col >= 0, out[2].reshape(-1), -1))
        cur = n_id
    if with_slots:
        return cur, rows, cols, slot_lists
    return cur, rows, cols


def cpu_sample_multihop(indptr, indices, seeds, sizes: Sequence[int],
                        seed: int = 0, num_threads: int = 0, weights=None,
                        row_cap: int = 2048, with_slots: bool = False):
    """Every hop of ``sizes`` on the host, with the device sampler's
    static shapes (capacity ``s * (1 + k)`` per hop, -1 fill), so host
    and device batches interleave. Hop ``li`` draws with seed ``seed +
    li``; with ``weights`` every hop is the weighted draw. Returns
    ``(n_id, rows, cols)``, with ``with_slots`` also each hop's flat CSR
    slots (``[s*k]`` int64, -1 fill, aligned with rows and cols)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    return _multihop(cpu_sample_layer, cpu_sample_layer_weighted,
                     cpu_reindex, indptr, indices, seeds, sizes, seed,
                     num_threads, weights, row_cap, with_slots)


# -- the plain versions -------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_ROW_KEY = np.uint64(0xD1B54A32D192ED03)


def _splitmix_draws(seed: int, v: np.ndarray, k: int) -> np.ndarray:
    """``[len(v), k]`` uint64: the first ``k`` splitmix64 outputs of each
    row ``v``'s stream, state ``seed ^ (ROW_KEY * (v + 1))``."""
    state = np.uint64(seed & (2**64 - 1)) ^ (
        _ROW_KEY * (v.astype(np.uint64) + np.uint64(1)))
    out = np.empty((v.shape[0], k), np.uint64)
    for t in range(k):
        state = state + _GOLDEN
        z = (state ^ (state >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        out[:, t] = z ^ (z >> np.uint64(31))
    return out


def _rows_of(indptr, seeds):
    """Valid seed positions, their row starts and degrees."""
    pos = np.flatnonzero(seeds >= 0)
    v = seeds[pos].astype(np.int64)
    start = indptr[v]
    return pos, v, start, indptr[v + 1] - start


def _finish(indices, slots, counts, with_slots):
    nbrs = np.where(slots >= 0, indices[np.maximum(slots, 0)], -1) \
        .astype(np.int32)
    return (nbrs, counts, slots) if with_slots else (nbrs, counts)


def sample_layer_plain(indptr, indices, seeds, k: int, seed: int = 0,
                       num_threads: int = 0, with_slots: bool = False):
    """:func:`cpu_sample_layer` in numpy (``num_threads`` is ignored: the
    draws do not depend on it)."""
    indptr, indices, seeds = _inputs(indptr, indices, seeds, k)
    s = seeds.shape[0]
    slots = np.full((s, k), -1, np.int64)
    counts = np.zeros((s,), np.int32)
    pos, v, start, deg = _rows_of(indptr, seeds)
    counts[pos] = np.minimum(deg, k)
    small = deg <= k
    for i, st, d in zip(pos[small], start[small], deg[small]):
        slots[i, :d] = np.arange(st, st + d)
    big = ~small
    degb = deg[big].astype(np.uint64)
    z = _splitmix_draws(seed, v[big], k)
    # the positions j = t + z % (deg - t) of the partial Fisher-Yates
    js = np.stack([t + (z[:, t] % (degb - np.uint64(t))).astype(np.int64)
                   for t in range(k)], axis=1) if k else z
    for i, st, row_js in zip(pos[big], start[big], js):
        log = {}                 # the write log: position -> value
        for t, j in enumerate(row_js.tolist()):
            slots[i, t] = st + log.get(j, j)
            log[j] = log.get(t, t)
    return _finish(indices, slots, counts, with_slots)


def sample_layer_weighted_plain(indptr, indices, weights, seeds, k: int,
                                seed: int = 0, row_cap: int = 2048,
                                num_threads: int = 0,
                                with_slots: bool = False):
    """:func:`cpu_sample_layer_weighted` in numpy: the CDF summed in
    float64 in slot order (``np.cumsum``, as the engine's loop), each
    draw ``u = (z >> 11) * 2**-53 * total`` found by an upper-bound
    search."""
    indptr, indices, seeds = _inputs(indptr, indices, seeds, k)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    row_cap = max(int(row_cap), 1)
    s = seeds.shape[0]
    slots = np.full((s, k), -1, np.int64)
    counts = np.zeros((s,), np.int32)
    pos, v, start, deg = _rows_of(indptr, seeds)
    z = _splitmix_draws(seed, v, k)
    for r, (i, st, d) in enumerate(zip(pos, start, deg)):
        pool = int(min(d, row_cap))
        w = weights[st:st + pool].astype(np.float64)
        cdf = np.cumsum(np.where(w > 0.0, w, 0.0))
        total = float(cdf[-1]) if pool else 0.0
        if total <= 0.0:
            continue
        c = int(min(d, k))
        counts[i] = c
        u = (z[r, :c] >> np.uint64(11)).astype(np.float64) \
            * (1.0 / 9007199254740992.0) * total
        p = np.searchsorted(cdf, u, side="right")
        slots[i, :c] = st + np.minimum(p, pool - 1)
    return _finish(indices, slots, counts, with_slots)


def reindex_plain(seeds, nbrs):
    """:func:`cpu_reindex` in numpy: the same ids in the same
    first-occurrence order (seeds, then the picks row by row)."""
    seeds = np.ascontiguousarray(seeds, dtype=np.int32)
    nbrs = np.ascontiguousarray(nbrs, dtype=np.int32)
    s, k = nbrs.shape
    picks = np.where((seeds >= 0)[:, None], nbrs, -1).reshape(-1)
    flat = np.concatenate([seeds, picks])
    valid = flat >= 0
    uniq, first = np.unique(flat[valid], return_index=True)
    order = np.argsort(np.flatnonzero(valid)[first], kind="stable")
    count = int(uniq.shape[0])
    n_id = np.full((s + s * k,), -1, np.int32)
    n_id[:count] = uniq[order]
    rank = np.empty((count,), np.int32)
    rank[order] = np.arange(count, dtype=np.int32)
    local = np.full(flat.shape, -1, np.int32)
    local[valid] = rank[np.searchsorted(uniq, flat[valid])]
    edge = local[s:] >= 0
    row = np.where(edge, np.repeat(local[:s], k), -1).astype(np.int32)
    col = np.where(edge, local[s:], -1).astype(np.int32)
    return n_id, count, row, col


def sample_multihop_plain(indptr, indices, seeds, sizes: Sequence[int],
                          seed: int = 0, num_threads: int = 0, weights=None,
                          row_cap: int = 2048, with_slots: bool = False):
    """:func:`cpu_sample_multihop` through the plain versions."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    return _multihop(sample_layer_plain, sample_layer_weighted_plain,
                     reindex_plain, indptr, indices, seeds, sizes, seed,
                     num_threads, weights, row_cap, with_slots)
