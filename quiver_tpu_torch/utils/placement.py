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
