"""Fused sample hop and fused sample+gather hop (counterpart of
``quiver_tpu/ops/pallas/fused.py``).

Two kernels, written in CUDA for Hopper in ``csrc/fused_hop.cu``:

- :func:`fused_sample_hop` samples ``min(deg, k)`` distinct neighbours
  per seed from its first ``row_cap`` neighbours, reading each seed's
  ``indptr`` pair itself (interior hops of the walk);
- :func:`fused_hot_hop` does the same and, in the same kernel, gathers
  the feature rows of every seed and every pick, with the optional
  ``feature_order`` translation, the ``hot_rows`` bound and the int8
  dequant (the leaf hop).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the kernel's plain PyTorch version only for tensors on the CPU. The
random bits are the counter hash of ``_rng``, so both versions, and the
JAX package's Pallas kernels with ``rng="hash"``, pick the same
neighbours bit for bit given the same int32 seed.

Unlike the JAX functions these take the plain CSR ``indices`` (no
``pad_indices`` window padding: the CUDA kernel reads
``indices[start + pos]`` directly) and, for the walk, explicit int32
per-hop seeds in place of a JAX random key.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import quant
from ..sample import compact_layer
from . import _build
from ._rng import BLOCK, block_base, rand_bits

_LIB = "fused_hop"

# launches of each kernel since the last reset_launches(); a wrapper adds
# one exactly where it launches its kernel
LAUNCHES = {"fused_sample_hop": 0, "fused_hot_hop": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    lib = _build.load(_LIB)
    if not getattr(lib, "_qt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qt_fused_sample_hop.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.qt_fused_sample_hop.restype = i
        lib.qt_fused_hot_hop.argtypes = [p, p, p, i, i, i, i, i, p, p, p, i,
                                         i, i, p, i, i, p, p, p, p, p]
        lib.qt_fused_hot_hop.restype = i
        lib.qt_max_k.argtypes = []
        lib.qt_max_k.restype = i
        lib._qt_bound = True
    return lib


def build_kernels() -> None:
    """Compile the kernels now (``chip_smoke.py`` times this as set-up)."""
    _build.build([_LIB])
    _lib()


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# -- plain PyTorch versions ---------------------------------------------------


def _seed_rows(indptr, seeds):
    """(start, deg) per seed: clipped to [0, n-1], -1 seeds read degree
    0 at start 0 (``fused.py:144-185``)."""
    n = indptr.shape[0] - 1
    valid = seeds >= 0
    if n <= 0:
        z = torch.zeros_like(seeds, dtype=torch.int64)
        return z, z
    p = seeds.long().clamp(0, n - 1)
    lo = indptr.long()[p]
    hi = indptr.long()[p + 1]
    zero = torch.zeros_like(lo)
    return torch.where(valid, lo, zero), torch.where(valid, hi - lo, zero)


def fy_positions(degs: torch.Tensor, k: int, row_cap: int,
                 seed: int) -> torch.Tensor:
    """Partial Fisher-Yates with a k-entry write log (counterpart of
    ``sample_kernel._fy_positions``): positions ``[bs, k]`` without
    replacement in ``[0, min(deg, row_cap))``. Seed ``s`` draws as lane
    ``s % 128`` of block ``s // 128``, one draw per step."""
    bs = degs.shape[0]
    dev = degs.device
    sidx = torch.arange(bs, dtype=torch.int64, device=dev)
    base = block_base(seed, sidx // BLOCK)
    lane = sidx % BLOCK
    pool = torch.clamp(degs.long(), max=row_cap)
    pos_log = torch.full((bs, k), -1, dtype=torch.int64, device=dev)
    val_log = torch.zeros((bs, k), dtype=torch.int64, device=dev)
    steps = torch.arange(k, dtype=torch.int64, device=dev)

    def lookup(x):
        match = pos_log == x[:, None]
        last = torch.where(match, steps, -1).amax(dim=1)
        logged = val_log.gather(1, last.clamp(min=0)[:, None])[:, 0]
        return torch.where(last >= 0, logged, x)

    outs = []
    for i in range(k):
        span = torch.clamp(pool - i, min=1)
        j = i + rand_bits(base, lane, i) % span
        a_j = lookup(j)
        a_i = lookup(torch.full_like(j, i))
        outs.append(a_j)
        pos_log[:, i] = j
        val_log[:, i] = a_i
    if not outs:
        return torch.zeros((bs, 0), dtype=torch.int64, device=dev)
    return torch.stack(outs, dim=1)


def sample_hop_plain(indptr, indices, seeds, k: int, seed: int,
                     row_cap: int = 2048):
    """Plain version of :func:`fused_sample_hop`: ``(nbrs [bs, k] int32
    -1 filled, counts [bs] int32)``."""
    start, deg = _seed_rows(indptr, seeds)
    counts = torch.clamp(deg, max=k)
    bs = seeds.shape[0]
    if indices.numel() == 0 or bs == 0:
        return (torch.full((bs, k), -1, dtype=torch.int32,
                           device=seeds.device),
                counts.to(torch.int32))
    pos = fy_positions(deg, k, row_cap, seed)
    take = torch.arange(k, device=seeds.device)[None, :] < counts[:, None]
    at = torch.where(take, start[:, None] + pos, 0)
    nbrs = torch.where(take, indices.long()[at], -1)
    return nbrs.to(torch.int32), counts.to(torch.int32)


def _oracle_rows(feat, ids, feature_order=None,
                 hot_rows: Optional[int] = None):
    """The plain lookup the fused gather matches bit for bit: the
    ``feature_order`` translation, the hot-tier bound and the
    multiply-mask that zeroes invalid and cold rows."""
    tier_n = quant.tier_rows(feat)
    ids = ids.long()
    if feature_order is not None:
        t = feature_order.long()[ids.clamp(0, feature_order.shape[0] - 1)]
        hot = tier_n if hot_rows is None else hot_rows
        valid = (ids >= 0) & (t < hot)
        safe = t.clamp(0, tier_n - 1)
    else:
        valid = ids >= 0
        safe = ids.clamp(0, tier_n - 1)
    x = quant.gather_rows(feat, safe)
    return x * valid.to(x.dtype)[:, None]


def hot_hop_plain(indptr, indices, seeds, feat, k: int, seed: int,
                  row_cap: int = 2048, feature_order=None,
                  hot_rows: Optional[int] = None):
    """Plain version of :func:`fused_hot_hop` (the JAX package's split
    oracle ``fused_hot_hop_reference``: sample, then look the rows up)."""
    nbrs, counts = sample_hop_plain(indptr, indices, seeds, k, seed,
                                    row_cap)
    return (nbrs, counts,
            _oracle_rows(feat, seeds, feature_order, hot_rows),
            _oracle_rows(feat, nbrs.reshape(-1), feature_order, hot_rows))


fused_hot_hop_reference = hot_hop_plain


# -- wrappers ------------------------------------------------------------------


def _check_1d_int32(t, name, dev):
    if not torch.is_tensor(t) or t.dtype != torch.int32 or t.dim() != 1 \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(
            f"{name} must be a contiguous 1-D int32 tensor on {dev}, got "
            f"{getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} on "
            f"{getattr(t, 'device', None)}")


def _check_common(indptr, indices, seeds, k, row_cap):
    dev = seeds.device
    for t, name in ((indptr, "indptr"), (indices, "indices"),
                    (seeds, "seeds")):
        _check_1d_int32(t, name, dev)
    if indptr.shape[0] < 1:
        raise ValueError("indptr must hold at least one entry")
    if not 1 <= k <= row_cap:
        raise ValueError(f"need 1 <= k <= row_cap, got k={k}, "
                         f"row_cap={row_cap}")
    if dev.type == "cuda":
        kmax = _lib().qt_max_k()
        if k > kmax:
            raise ValueError(f"the CUDA kernels take k <= {kmax}, got {k}")
    return dev


def _i32(seed) -> int:
    """A Python int seed as the kernel sees it (int32, two's complement)."""
    s = int(seed) & 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


def fused_sample_hop(indptr, indices, seeds, k: int, seed,
                     row_cap: int = 2048):
    """One sampling hop: ``(nbrs [bs, k] int32, counts [bs] int32)``.
    Every tensor is int32, contiguous and on one device."""
    dev = _check_common(indptr, indices, seeds, k, row_cap)
    seed = _i32(seed)
    if dev.type == "cpu":
        return sample_hop_plain(indptr, indices, seeds, k, seed, row_cap)
    if dev.type != "cuda":
        raise ValueError(f"fused_sample_hop runs on cuda or cpu, not {dev}")
    bs = seeds.shape[0]
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=dev)
    counts = torch.empty((bs,), dtype=torch.int32, device=dev)
    if bs == 0:
        return nbrs, counts
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_fused_sample_hop(
            indptr.data_ptr(), indices.data_ptr(), seeds.data_ptr(), bs,
            indptr.shape[0] - 1, k, row_cap, seed, nbrs.data_ptr(),
            counts.data_ptr(), stream)
    _check_launch(err, "fused_sample_hop")
    LAUNCHES["fused_sample_hop"] += 1
    return nbrs, counts


def _check_feat(feat, dev):
    data, scale, zero = quant.tier_parts(feat)
    ok = torch.is_tensor(data) and data.dim() == 2 \
        and data.is_contiguous() and data.device == dev
    if quant.is_quantized(feat):
        ok = ok and data.dtype == torch.int8
        for side in (scale, zero):
            ok = ok and side.dtype == torch.float32 \
                and tuple(side.shape) == (data.shape[0], 1) \
                and side.is_contiguous() and side.device == dev
    else:
        ok = ok and data.dtype == torch.float32
    if not ok or data.shape[0] < 1:
        raise ValueError(
            "fused_hot_hop takes a contiguous fp32 [N, D] table, or an "
            "int8 [N, D] QuantizedTensor with fp32 [N, 1] scale and zero, "
            f"on {dev} with N >= 1")
    return data, scale, zero


def fused_hot_hop(indptr, indices, seeds, feat, k: int, seed,
                  row_cap: int = 2048, feature_order=None,
                  hot_rows: Optional[int] = None):
    """One fused hop: sample ``k`` neighbours per seed AND gather the
    rows of seeds and picks. Returns ``(nbrs [bs, k], counts [bs],
    seed_rows [bs, D], pick_rows [bs*k, D])``, ``pick_rows`` row-major
    over ``nbrs``, invalid (-1) and cold rows multiplied by zero.
    ``feature_order`` (old id -> storage row) is optional, and
    ``hot_rows`` (default: every row) bounds the hot tier only together
    with it."""
    dev = _check_common(indptr, indices, seeds, k, row_cap)
    data, scale, zero = _check_feat(feat, dev)
    if feature_order is not None:
        _check_1d_int32(feature_order, "feature_order", dev)
        if feature_order.shape[0] < 1:
            raise ValueError("feature_order must not be empty")
    seed = _i32(seed)
    if dev.type == "cpu":
        return hot_hop_plain(indptr, indices, seeds, feat, k, seed, row_cap,
                             feature_order, hot_rows)
    if dev.type != "cuda":
        raise ValueError(f"fused_hot_hop runs on cuda or cpu, not {dev}")
    bs = seeds.shape[0]
    tier_n, dim = data.shape
    hot = tier_n if hot_rows is None else int(hot_rows)
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=dev)
    counts = torch.empty((bs,), dtype=torch.int32, device=dev)
    seed_rows = torch.empty((bs, dim), dtype=torch.float32, device=dev)
    pick_rows = torch.empty((bs * k, dim), dtype=torch.float32, device=dev)
    if bs == 0:
        return nbrs, counts, seed_rows, pick_rows
    quantized = scale is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_fused_hot_hop(
            indptr.data_ptr(), indices.data_ptr(), seeds.data_ptr(), bs,
            indptr.shape[0] - 1, k, row_cap, seed, data.data_ptr(),
            scale.data_ptr() if quantized else None,
            zero.data_ptr() if quantized else None, int(quantized),
            tier_n, dim,
            None if feature_order is None else feature_order.data_ptr(),
            0 if feature_order is None else feature_order.shape[0], hot,
            nbrs.data_ptr(), counts.data_ptr(), seed_rows.data_ptr(),
            pick_rows.data_ptr(), stream)
    _check_launch(err, "fused_hot_hop")
    LAUNCHES["fused_hot_hop"] += 1
    return nbrs, counts, seed_rows, pick_rows


# -- the walk ------------------------------------------------------------------


def _check_walk(sizes, hop_seeds):
    if not sizes:
        raise ValueError("sizes must name at least one hop")
    if len(hop_seeds) != len(sizes):
        raise ValueError(f"need one seed per hop: {len(sizes)} hops, "
                         f"{len(hop_seeds)} seeds")


def fused_sample_multihop(indptr, indices, seeds, sizes: Sequence[int],
                          hop_seeds: Sequence[int], row_cap: int = 2048):
    """Walk the fanout ladder with the sampling kernel, compacting each
    hop's frontier into the next hop's static seed budget. ``seeds``
    must be dense (distinct valid ids, -1 tail only). Returns
    ``(n_id, layers)``."""
    _check_walk(sizes, hop_seeds)
    cur = seeds
    layers = []
    for k, s in zip(sizes, hop_seeds):
        nbrs, _ = fused_sample_hop(indptr, indices, cur, int(k), s, row_cap)
        layers.append(compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    return cur, layers


def fused_multihop(indptr, indices, seeds, feat, sizes: Sequence[int],
                   hop_seeds: Sequence[int], row_cap: int = 2048,
                   feature_order=None, hot_rows: Optional[int] = None):
    """The fused frontier walk: interior hops run
    :func:`fused_sample_hop`, the leaf hop :func:`fused_hot_hop`, and
    ``compact_layer`` dedups between hops. Each compacted frontier keeps
    its predecessor as its slot-[0, v) prefix, so the leaf hop's seeds
    are the whole interior and two scatters assemble the ``[cap, D]``
    block. Returns ``(n_id, layers, x)``; padding slots of ``x`` are
    +0.0. ``hop_seeds`` are the per-hop int32 kernel seeds."""
    _check_walk(sizes, hop_seeds)
    cur = seeds
    layers = []
    last = len(sizes) - 1
    for i, (k, s) in enumerate(zip(sizes, hop_seeds)):
        if i < last:
            nbrs, _ = fused_sample_hop(indptr, indices, cur, int(k), s,
                                       row_cap)
        else:
            leaf_seeds = cur
            nbrs, _, seed_rows, pick_rows = fused_hot_hop(
                indptr, indices, cur, feat, int(k), s, row_cap,
                feature_order, hot_rows)
        layers.append(compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    leaf = layers[-1]
    n = leaf_seeds.shape[0]
    cap = leaf.n_id.shape[0]
    dev = seed_rows.device
    # one spare row takes every -1 slot and is cut off afterwards;
    # duplicate picks carry identical bits, so write order is irrelevant
    x = torch.zeros((cap + 1, seed_rows.shape[1]), dtype=seed_rows.dtype,
                    device=dev)
    slot = torch.where(leaf_seeds >= 0,
                       torch.arange(n, device=dev), cap)
    x.index_copy_(0, slot, seed_rows)
    x.index_copy_(0, torch.where(leaf.col >= 0, leaf.col.long(), cap),
                  pick_rows)
    return leaf.n_id, layers, x[:cap]


def fused_multihop_reference(indptr, indices, seeds, feat,
                             sizes: Sequence[int], hop_seeds: Sequence[int],
                             row_cap: int = 2048, feature_order=None,
                             hot_rows: Optional[int] = None):
    """The plain multi-hop walk: per-hop plain sampling, compaction and
    one plain lookup over the final frontier, on any device. Matches
    :func:`fused_multihop` bit for bit on ``n_id``, the layer COOs and
    every valid row of ``x``."""
    _check_walk(sizes, hop_seeds)
    cur = seeds
    layers = []
    for k, s in zip(sizes, hop_seeds):
        nbrs, _ = sample_hop_plain(indptr, indices, cur, int(k), _i32(s),
                                   row_cap)
        layers.append(compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    return cur, layers, _oracle_rows(feat, cur, feature_order, hot_rows)
