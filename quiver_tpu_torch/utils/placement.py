"""Pinned host memory placement (counterpart of ``pinned_put`` in
``quiver_tpu/utils/placement.py``).

The feature store's cold tier and the sampler's HOST-mode topology live
in pinned host memory, where the card's gathers read them over PCIe. The
JAX package probes whether its backend can use the placement and, with
``allow_fallback``, falls back loudly to default placement where it
cannot; here there is nothing to probe: on a card, pinning either works
or is an error, and on the CPU (the caller asked for it) the arrays stay
in plain host memory. So the sampler's ``allow_fallback`` (kept in its
signature and its IPC handle) cannot make a card run unpinned.

An int8 tier with fp32 sidecars is packed (``ops/quant.py: pack``): each
row's codes, scale and zero in one aligned host row, which the gather
reads in one request. The CPU gets the same packed views, so its plain
gather reads the layout the card reads.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..ops import quant


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (on any device), made in one copy."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _host(tier, pin: bool):
    if isinstance(tier, np.ndarray):
        tier = torch.from_numpy(np.ascontiguousarray(tier))
    if quant.is_quantized(tier) and tier.scale.dtype == torch.float32 \
            and tier.zero.dtype == torch.float32:
        return quant.pack(tier, pin=pin)
    if pin:
        return quant.tree_map_tier(_pinned, tier)
    return quant.tree_map_tier(lambda t: t.cpu().contiguous(), tier)


def pinned_put(tier, device: torch.device, what: str):
    """A host tier (a CPU tensor, or a ``QuantizedTensor`` of them), or
    a topology array of the sampler's HOST mode (a 1-D int32 or int64
    ``indptr``, ``indices`` or edge-id map, a 2-D int32 rows view; a
    tensor on any device or a numpy array), placed where ``device``'s
    reads find it: pinned (page-locked, mapped for the card) when
    ``device`` is a CUDA device, in plain host memory for the CPU; an
    int8 tier with fp32 sidecars packed either way. Raises when pinning
    fails (``what`` names the array in the message)."""
    if device.type == "cpu":
        return _host(tier, pin=False)
    if device.type != "cuda":
        raise ValueError(f"cannot place {what} for {device}")
    try:
        return _host(tier, pin=True)
    except RuntimeError as e:
        raise RuntimeError(f"pinning {what} in host memory failed: {e}") \
            from e


# -- host tiers shared between processes --------------------------------------
# torch cannot move a pinned (cudaHostAlloc) tensor into shared memory, so a
# host tier meant for other processes is copied once into shared pages,
# which are then registered with CUDA (cudaHostRegister): pinned and
# mapped for the card, and sent to a torch.multiprocessing worker by file
# descriptor. The worker registers its own mapping of the same pages.
#
# A registration lasts until it is undone, and the CUDA driver keeps it past
# the unmapping of its pages: a later host allocation at the same addresses
# would then be read from the old pages (a copy to the card lands other
# bytes) or fail with cudaErrorInvalidValue where it overlaps the old range
# in part. So each registration is undone when its storage is freed.

_HOST_REGISTER_MAPPED = 3          # cudaHostRegisterPortable | Mapped


def _unregister(ptr: int) -> None:
    err = int(torch.cuda.cudart().cudaHostUnregister(ptr))
    if err != 0:
        raise RuntimeError(f"cudaHostUnregister of a freed shared host "
                           f"tier failed with CUDA error {err}")


def _register(storage) -> None:
    """Page-lock one shared CPU storage for the cards (once), until the
    storage is freed."""
    if storage.nbytes() == 0:
        return
    probe = torch.empty(0, dtype=torch.uint8).set_(storage)
    if probe.is_pinned():
        return
    ptr = storage.data_ptr()
    err = torch.cuda.cudart().cudaHostRegister(
        ptr, storage.nbytes(), _HOST_REGISTER_MAPPED)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of a shared host tier "
                           f"failed with CUDA error {int(err)}")
    # torch keeps a storage's Python object as long as any tensor holds
    # the storage, so this runs when the pages are freed
    weakref.finalize(storage, _unregister, ptr).atexit = False


def _storages(tier):
    """The distinct storages of a tier's leaves (a packed tier's three
    views share one)."""
    seen = {}
    for t in quant.tier_parts(tier):
        if t is not None:
            st = t.untyped_storage()
            seen.setdefault(st.data_ptr(), st)
    return list(seen.values())


def _to_shared(t: torch.Tensor) -> torch.Tensor:
    """A copy of the CPU tensor ``t`` in shared memory, same layout: its
    whole storage is copied, so views keep their offsets and strides."""
    src = t.untyped_storage()
    buf = torch.empty(src.nbytes(), dtype=torch.uint8).share_memory_()
    buf.copy_(torch.empty(0, dtype=torch.uint8).set_(src))
    return torch.empty(0, dtype=t.dtype).set_(
        buf.untyped_storage(), t.storage_offset(), t.shape, t.stride())


def share_host(tier, device: torch.device):
    """A host tier (pinned or not, packed or not) in shared memory that
    ``device`` reads: registered (pinned) for a card, plain on the CPU.
    A tier already shared is returned as it is. The leaves of a packed
    tier stay views into one shared buffer."""
    parts = quant.tier_parts(tier)
    if all(t is None or t.is_shared() for t in parts):
        shared = tier
    elif quant.is_quantized(tier):
        buf = {}

        def move(t):
            key = t.untyped_storage().data_ptr()
            if key not in buf:
                buf[key] = _to_shared(t)
            return torch.empty(0, dtype=t.dtype).set_(
                buf[key].untyped_storage(), t.storage_offset(), t.shape,
                t.stride())
        shared = quant.QuantizedTensor(*(move(t) for t in parts))
    else:
        shared = _to_shared(tier)
    if device.type == "cuda":
        register_host(shared, device)
    return shared


def register_host(tier, device: torch.device):
    """Pin a host tier that lies in shared memory for ``device``'s reads
    (a no-op on the CPU and for pages already pinned); returns it."""
    if device.type == "cuda":
        for st in _storages(tier):
            _register(st)
    return tier
