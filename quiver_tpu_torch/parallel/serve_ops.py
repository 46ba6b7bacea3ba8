"""The pieces of ``quiver_tpu/parallel/train.py`` that the serve path
runs: hop COOs to ``Adj``s, the masked frontier gather, the fused
frontier walk and its knob check. The train step itself waits for a
later slice of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import quant
from ..ops.kernels.fused import fused_multihop
from ..pyg.sage_sampler import Adj, layer_shapes


def layers_to_adjs(layers, batch_size: int, sizes: Sequence[int]):
    """LayerSamples (sampling order) -> Adj list (outermost hop first)."""
    adjs = []
    for layer, shape in zip(layers, layer_shapes(batch_size, sizes)):
        adjs.append(Adj(edge_index=torch.stack([layer.col, layer.row]),
                        e_id=layer.e_id,
                        size=(shape.n_id_cap, shape.num_seeds),
                        mask=layer.col >= 0))
    return adjs[::-1]


def masked_feature_gather(feat, n_id: torch.Tensor,
                          feature_order=None) -> torch.Tensor:
    """Feature rows for a -1-padded frontier, through the optional
    hot-order indirection; padded rows come back zeroed. ``feat`` is a
    tensor or a ``QuantizedTensor`` (dequant fused into the gather)."""
    ids = n_id.long()
    if feature_order is not None:
        ids = feature_order.long()[ids.clamp(min=0)]
    safe = ids.clamp(0, quant.tier_rows(feat) - 1)
    x = quant.gather_rows(feat, safe)
    return x * (n_id >= 0).to(x.dtype)[:, None]


def _fused_multihop_x(feat, forder, indptr, indices, seeds,
                      sizes: Sequence[int], hop_seeds: Sequence[int],
                      row_cap: int = 2048, hot_rows: Optional[int] = None):
    """The fused frontier walk (``ops.kernels.fused.fused_multihop``):
    interior hops run the sampling kernel, the leaf hop samples and
    gathers in one kernel. Hop ``i`` draws from ``hop_seeds[i]``.
    Returns ``(x, layers)``."""
    _, layers, x = fused_multihop(
        indptr, indices, seeds, feat, list(sizes), hop_seeds,
        row_cap=row_cap, feature_order=forder, hot_rows=hot_rows)
    return x, layers


def _fused_knobs(enabled, row_cap, sizes, method, dedup_gather=None):
    """Validate and pack the ``fused_hot_hop`` builder knobs: the walk
    covers any exact-method fanout ladder and gathers in-kernel, so it
    composes with nothing that reshapes sampling or the gather."""
    if not enabled:
        return None
    if not sizes:
        raise ValueError("fused_hot_hop needs at least one hop in sizes")
    if method != "exact":
        raise ValueError(
            f"fused_hot_hop requires method='exact', got {method!r}")
    if dedup_gather is not None:
        raise ValueError(
            "fused_hot_hop gathers in-kernel (one row per frontier "
            "slot); dedup_gather does not compose with it")
    return {"row_cap": int(row_cap)}
