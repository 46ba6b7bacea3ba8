"""The neighbour-sampling layer (counterpart of
``quiver_tpu/ops/pallas/sample_kernel.py``).

:func:`sample_layer_kernel` draws, for each seed, ``min(deg, k)``
distinct neighbours from its first ``row_cap`` CSR entries. As
``sample_layer_pallas`` does, the wrapper reads each seed's start and
degree with tensor ops and hands them to the kernel through device
memory (``csrc/sample_kernel.cu``): this is the sampler of the split
walk, where the fused hops of ``fused.py`` read the ``indptr`` pair
inside the kernel. Both run one selection on one random stream
(``csrc/sample_common.cuh``), so their picks are equal for the same
seeds and int32 seed.

The selection :func:`fy_positions` and the row lookup :func:`_seed_rows`
are the plain versions shared with ``fused.py``, as the JAX package's
``fused.py`` imports ``_fy_positions`` from its ``sample_kernel``. So are
the argument checks of the sampling wrappers. Unlike the JAX function,
this one takes the plain CSR ``indices`` (no ``pad_indices`` window
padding) and only the ``"hash"`` random stream.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._rng import BLOCK, block_base, rand_bits

_LIB = "sample_kernel"


def _lib():
    lib = _build.load(_LIB)
    if not getattr(lib, "_qt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qt_sample_layer.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.qt_sample_layer.restype = i
        lib.qt_max_k.argtypes = []
        lib.qt_max_k.restype = i
        lib._qt_max_k = lib.qt_max_k()
        lib._qt_bound = True
    return lib


# -- plain PyTorch versions ---------------------------------------------------


def _seed_rows(indptr, seeds):
    """(start, deg) per seed: clipped to [0, n-1], -1 seeds read degree
    0 at start 0 (``sample_kernel.py:162-166``); a graph with no nodes
    gives degree 0. Both come back in ``indptr``'s dtype."""
    n = indptr.shape[0] - 1
    if n <= 0:
        z = torch.zeros_like(seeds, dtype=indptr.dtype)
        return z, z
    valid = seeds >= 0
    p = seeds.clamp(0, n - 1).long()
    lo = indptr[p]
    deg = indptr[p + 1] - lo
    return torch.where(valid, lo, 0), torch.where(valid, deg, 0)


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


def sample_layer_plain(indptr, indices, seeds, k: int, seed: int,
                       row_cap: int = 2048):
    """Plain version of :func:`sample_layer_kernel` (and of
    ``fused.fused_sample_hop``, which computes the same function):
    ``(nbrs [bs, k] int32 -1 filled, counts [bs] int32)``."""
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


# -- argument checks shared by the sampling wrappers ---------------------------


def _check_1d_int32(t, name, dev):
    if not torch.is_tensor(t) or t.dtype != torch.int32 or t.dim() != 1 \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(
            f"{name} must be a contiguous 1-D int32 tensor on {dev}, got "
            f"{getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} on "
            f"{getattr(t, 'device', None)}")


def _check_common(indptr, indices, seeds, k, row_cap, lib):
    """Checks the CSR, the seeds and ``k``; ``lib`` loads the library
    whose ``qt_max_k`` (read once, when the library is bound) bounds
    ``k`` on the card."""
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
        kmax = lib()._qt_max_k
        if k > kmax:
            raise ValueError(f"the CUDA kernels take k <= {kmax}, got {k}")
    elif dev.type != "cpu":
        raise ValueError(f"the sampling kernels run on cuda or cpu, "
                         f"not {dev}")
    return dev


def _i32(seed) -> int:
    """A Python int seed as the kernel sees it (int32, two's complement)."""
    s = int(seed) & 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


# -- wrapper -------------------------------------------------------------------


@_build.recorded("sample_layer_kernel")
def sample_layer_kernel(indptr, indices, seeds, k: int, seed,
                        row_cap: int = 2048, rng: str = "hash"):
    """One sampling layer of the split walk: ``(nbrs [bs, k] int32 -1
    filled, counts [bs] int32)``, ``counts = min(deg, k)``. Every tensor
    is int32, contiguous and on one device; ``seed`` is taken as an
    int32. Only the ``"hash"`` stream is ported: the TPU's on-core
    generator (``rng="tpu"``) has no counterpart here."""
    if rng != "hash":
        raise ValueError(f"sample_layer_kernel draws from the 'hash' "
                         f"stream only, not rng={rng!r}")
    dev = _check_common(indptr, indices, seeds, k, row_cap, _lib)
    seed = _i32(seed)
    if dev.type == "cpu":
        return sample_layer_plain(indptr, indices, seeds, k, seed, row_cap)
    bs = seeds.shape[0]
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=dev)
    counts = torch.empty((bs,), dtype=torch.int32, device=dev)
    if bs == 0:
        return nbrs, counts
    # the split walk's round trip: int32 starts and degrees through
    # device memory
    start, deg = _seed_rows(indptr, seeds)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_sample_layer(
            indices.data_ptr(), start.data_ptr(), deg.data_ptr(), bs, k,
            row_cap, seed, nbrs.data_ptr(), counts.data_ptr(), stream)
    _build.launched(err, "sample_layer")
    return nbrs, counts
