"""Pinned host memory placement (counterpart of ``pinned_put`` in
``quiver_tpu/utils/placement.py``).

The feature store's cold tier lives in pinned host memory, where the
card's row gather reads it over PCIe. The JAX package probes whether its
backend can use the placement and falls back loudly where it cannot;
here there is nothing to probe: on a card, pinning either works or is an
error, and on the CPU (the caller asked for it) the tier stays in plain
host memory.
"""

from __future__ import annotations

import torch

from ..ops import quant


def pinned_put(tier, device: torch.device, what: str):
    """A host tier (a CPU tensor, or a ``QuantizedTensor`` of them)
    placed where ``device``'s lookups read it: every leaf pinned
    (page-locked, mapped for the card) when ``device`` is a CUDA device,
    left in plain host memory for the CPU. Raises when pinning fails
    (``what`` names the tier in the message)."""
    if device.type == "cpu":
        return quant.tree_map_tier(lambda t: t.cpu().contiguous(), tier)
    if device.type != "cuda":
        raise ValueError(f"cannot place {what} for {device}")
    try:
        return quant.tree_map_tier(
            lambda t: t.cpu().contiguous().pin_memory(), tier)
    except RuntimeError as e:
        raise RuntimeError(f"pinning {what} in host memory failed: {e}") \
            from e
