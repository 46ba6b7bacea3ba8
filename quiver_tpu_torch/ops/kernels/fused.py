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

The walks: :func:`fused_multihop` (the fused walk of the served path)
and its plain version :func:`multihop_plain`; and, as in the JAX
package, the split walk :func:`fused_multihop_reference` (with its one
hop :func:`fused_hot_hop_reference`), which samples every hop with
``sample_kernel.sample_layer_kernel`` and is the fused walk's
acceptance oracle.

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
from ._build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .sample_kernel import (_check_1d_int32, _check_common, _i32,
                            sample_layer_kernel, sample_layer_plain)

_LIB = "fused_hop"


def _lib():
    lib = _build.load(_LIB)
    if not getattr(lib, "_qt_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qt_fused_sample_hop.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.qt_fused_sample_hop.restype = i
        lib.qt_fused_hot_hop.argtypes = [p, p, p, i, i, i, i, i, p, p, p, i,
                                         i, i, p, i, i, p, p, p, ll, i, p, p]
        lib.qt_fused_hot_hop.restype = i
        lib.qt_hot_hop_vec.argtypes = [p, i, i, p, ll, p]
        lib.qt_hot_hop_vec.restype = i
        lib.qt_max_k.argtypes = []
        lib.qt_max_k.restype = i
        lib._qt_max_k = lib.qt_max_k()
        lib._qt_bound = True
    return lib


# -- plain PyTorch versions ---------------------------------------------------


# B3 computes B1's function and only reads the indptr pair inside the
# kernel, so the two kernels share one plain version
sample_hop_plain = sample_layer_plain


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
    """Plain version of :func:`fused_hot_hop`: the plain sampler, then
    the plain lookup of the seeds' and picks' rows."""
    nbrs, counts = sample_hop_plain(indptr, indices, seeds, k, seed,
                                    row_cap)
    return (nbrs, counts,
            _oracle_rows(feat, seeds, feature_order, hot_rows),
            _oracle_rows(feat, nbrs.reshape(-1), feature_order, hot_rows))


# -- wrappers ------------------------------------------------------------------


@_build.recorded("fused_sample_hop")
def fused_sample_hop(indptr, indices, seeds, k: int, seed,
                     row_cap: int = 2048):
    """One sampling hop: ``(nbrs [bs, k] int32, counts [bs] int32)``.
    Every tensor is int32, contiguous and on one device."""
    dev = _check_common(indptr, indices, seeds, k, row_cap, _lib)
    seed = _i32(seed)
    if dev.type == "cpu":
        return sample_hop_plain(indptr, indices, seeds, k, seed, row_cap)
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
    _build.launched(err, "fused_sample_hop")
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


def _check_seed_rows_out(out, bs, dim, dev):
    if not torch.is_tensor(out) or out.dtype != torch.float32 \
            or tuple(out.shape) != (bs, dim) or out.device != dev \
            or (dim > 1 and out.stride(1) != 1) \
            or (bs > 1 and out.stride(0) < dim):
        raise ValueError(
            f"seed_rows_out must be an fp32 [{bs}, {dim}] tensor on {dev} "
            "with contiguous rows that do not overlap")


def hot_hop_vec(feat, seed_rows, pick_rows) -> int:
    """The values one thread of :func:`fused_hot_hop`'s kernel moves per
    gather word for ``feat`` into these outputs: 4 (4 int8 codes or
    16 B of fp32 in, 16 B out) when the width, the seed rows' stride and
    every base pointer are aligned for it, else 1."""
    data, scale, _ = quant.tier_parts(feat)
    return _lib().qt_hot_hop_vec(
        data.data_ptr(), int(scale is not None), data.shape[1],
        seed_rows.data_ptr(), seed_rows.stride(0), pick_rows.data_ptr())


@_build.recorded("fused_hot_hop")
def fused_hot_hop(indptr, indices, seeds, feat, k: int, seed,
                  row_cap: int = 2048, feature_order=None,
                  hot_rows: Optional[int] = None, seed_rows_out=None):
    """One fused hop: sample ``k`` neighbours per seed AND gather the
    rows of seeds and picks. Returns ``(nbrs [bs, k], counts [bs],
    seed_rows [bs, D], pick_rows [bs*k, D])``, ``pick_rows`` row-major
    over ``nbrs``, invalid (-1) and cold rows multiplied by zero.
    ``feature_order`` (old id -> storage row) is optional, and
    ``hot_rows`` (default: every row) bounds the hot tier only together
    with it. Given ``seed_rows_out`` (fp32 ``[bs, D]``, rows contiguous,
    on the seeds' device), the rows of the valid (``>= 0``) seeds are
    written there, the slots of -1 seeds keep what they hold, and it is
    returned as ``seed_rows``."""
    dev = _check_common(indptr, indices, seeds, k, row_cap, _lib)
    data, scale, zero = _check_feat(feat, dev)
    if feature_order is not None:
        _check_1d_int32(feature_order, "feature_order", dev)
        if feature_order.shape[0] < 1:
            raise ValueError("feature_order must not be empty")
    bs = seeds.shape[0]
    tier_n, dim = data.shape
    if seed_rows_out is not None:
        _check_seed_rows_out(seed_rows_out, bs, dim, dev)
    seed = _i32(seed)
    if dev.type == "cpu":
        nbrs, counts, seed_rows, pick_rows = hot_hop_plain(
            indptr, indices, seeds, feat, k, seed, row_cap, feature_order,
            hot_rows)
        if seed_rows_out is not None:
            valid = seeds >= 0
            seed_rows_out[valid] = seed_rows[valid]
            seed_rows = seed_rows_out
        return nbrs, counts, seed_rows, pick_rows
    hot = tier_n if hot_rows is None else int(hot_rows)
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=dev)
    counts = torch.empty((bs,), dtype=torch.int32, device=dev)
    seed_rows = seed_rows_out
    if seed_rows is None:
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
            seed_rows.stride(0), int(seed_rows_out is not None),
            pick_rows.data_ptr(), stream)
    _build.launched(err, "fused_hot_hop")
    return nbrs, counts, seed_rows, pick_rows


# -- the walk ------------------------------------------------------------------


def _check_walk(sizes, hop_seeds):
    if not sizes:
        raise ValueError("sizes must name at least one hop")
    if len(hop_seeds) != len(sizes):
        raise ValueError(f"need one seed per hop: {len(sizes)} hops, "
                         f"{len(hop_seeds)} seeds")


def _sample_walk(sample, indptr, indices, seeds, sizes, hop_seeds,
                 row_cap):
    """Walk the fanout ladder with ``sample`` (a sampling layer's
    signature), compacting each hop's frontier into the next hop's
    static seed budget. Returns ``(n_id, layers)``."""
    _check_walk(sizes, hop_seeds)
    cur = seeds
    layers = []
    for k, s in zip(sizes, hop_seeds):
        nbrs, _ = sample(indptr, indices, cur, int(k), _i32(s), row_cap)
        layers.append(compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    return cur, layers


def fused_sample_multihop(indptr, indices, seeds, sizes: Sequence[int],
                          hop_seeds: Sequence[int], row_cap: int = 2048):
    """Walk the fanout ladder with the sampling kernel, compacting each
    hop's frontier into the next hop's static seed budget. ``seeds``
    must be dense (distinct valid ids, -1 tail only). Returns
    ``(n_id, layers)``."""
    return _sample_walk(fused_sample_hop, indptr, indices, seeds, sizes,
                        hop_seeds, row_cap)


def fused_multihop(indptr, indices, seeds, feat, sizes: Sequence[int],
                   hop_seeds: Sequence[int], row_cap: int = 2048,
                   feature_order=None, hot_rows: Optional[int] = None):
    """The fused frontier walk: interior hops run
    :func:`fused_sample_hop`, the leaf hop :func:`fused_hot_hop`, and
    ``compact_layer`` dedups between hops. Each compacted frontier keeps
    its predecessor as its slot-[0, v) prefix, so the leaf hop's seeds
    are the whole interior: the leaf kernel writes their rows straight
    into slots ``[0, v)`` of the ``[cap, D]`` block, and one scatter adds
    the new picks' rows. Returns ``(n_id, layers, x)``; padding slots of
    ``x`` are +0.0. ``hop_seeds`` are the per-hop int32 kernel seeds."""
    _check_walk(sizes, hop_seeds)
    cur = seeds
    layers = []
    last = len(sizes) - 1
    for i, (k, s) in enumerate(zip(sizes, hop_seeds)):
        if i < last:
            nbrs, _ = fused_sample_hop(indptr, indices, cur, int(k), s,
                                       row_cap)
        else:
            # the leaf frontier's capacity is compact_layer's n + n*k; one
            # spare row takes every -1 pick and is cut off afterwards
            n = cur.shape[0]
            cap = n * (1 + int(k))
            x = torch.zeros((cap + 1, quant.tier_dim(feat)),
                            dtype=torch.float32, device=cur.device)
            nbrs, _, _, pick_rows = fused_hot_hop(
                indptr, indices, cur, feat, int(k), s, row_cap,
                feature_order, hot_rows, seed_rows_out=x[:n])
        layers.append(compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    leaf = layers[-1]
    # duplicate picks (and a pick of a seed) carry identical bits, so
    # write order is irrelevant
    x.index_copy_(0, torch.where(leaf.col >= 0, leaf.col.long(), cap),
                  pick_rows)
    return leaf.n_id, layers, x[:cap]


def multihop_plain(indptr, indices, seeds, feat, sizes: Sequence[int],
                   hop_seeds: Sequence[int], row_cap: int = 2048,
                   feature_order=None, hot_rows: Optional[int] = None):
    """Plain version of :func:`fused_multihop`, on any device: the plain
    sampler on every hop, compaction, and one plain lookup over the
    final frontier. Matches :func:`fused_multihop` bit for bit on
    ``n_id``, the layer COOs and every valid row of ``x``."""
    n_id, layers = _sample_walk(sample_hop_plain, indptr, indices, seeds,
                                sizes, hop_seeds, row_cap)
    return n_id, layers, _oracle_rows(feat, n_id, feature_order, hot_rows)


# -- the split walk (the JAX package's acceptance oracle) ----------------------


def fused_hot_hop_reference(indptr, indices, seeds, feat, k: int, seed,
                            row_cap: int = 2048, feature_order=None,
                            hot_rows: Optional[int] = None):
    """The split two-program hop (``fused.py: fused_hot_hop_reference``):
    :func:`sample_layer_kernel`, its picks going through device memory,
    then the plain lookup of the seeds' and picks' rows. Equals
    :func:`fused_hot_hop` bit for bit."""
    nbrs, counts = sample_layer_kernel(indptr, indices, seeds, k, seed,
                                       row_cap)
    return (nbrs, counts,
            _oracle_rows(feat, seeds, feature_order, hot_rows),
            _oracle_rows(feat, nbrs.reshape(-1), feature_order, hot_rows))


def fused_multihop_reference(indptr, indices, seeds, feat,
                             sizes: Sequence[int], hop_seeds: Sequence[int],
                             row_cap: int = 2048, feature_order=None,
                             hot_rows: Optional[int] = None):
    """The split walk (``fused.py: fused_multihop_reference``):
    :func:`sample_layer_kernel` on every hop, the frontier ids going
    through device memory between hops, compaction, and one plain lookup
    over the final frontier. :func:`fused_multihop` equals it bit for bit
    on ``n_id``, the layer COOs and every valid row of ``x``: the
    acceptance gate of the fused walk."""
    n_id, layers = _sample_walk(sample_layer_kernel, indptr, indices, seeds,
                                sizes, hop_seeds, row_cap)
    return n_id, layers, _oracle_rows(feat, n_id, feature_order, hot_rows)
