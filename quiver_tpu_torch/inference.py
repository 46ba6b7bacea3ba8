"""Layer-wise full-graph inference (counterpart of
``quiver_tpu/inference.py``).

Exact (not sampled) embeddings of every node, one layer at a time, over
batches of nodes, so no layer's activations for the whole graph need to
exist at once beyond its input and output. A batch's in-neighbourhood is
summed over ``ceil(max degree in the batch / max_degree)`` windows of
``max_degree`` neighbours each, so the mean is exact for any degree,
while every gather has the static shape ``[batch, max_degree, width]``.
A batch with no hub takes one window. The window sum accumulates into
one ``[batch, width]`` buffer in place.

There is no Pallas kernel here in the JAX package; the gathers are torch
indexing (``index_select``), and ``apply_layer`` is the model's own
linear layers.
"""

from __future__ import annotations

from typing import Callable

import torch

_INT32_MAX = 2**31 - 1


def neighborhood_block(indptr, indices, nodes, max_degree: int,
                       window=0):
    """For each node, its neighbours at row positions ``[window *
    max_degree, (window + 1) * max_degree)``, -1 past the row's end and
    for -1 nodes: ``([bs, max_degree] int32, degrees [bs] int32)``."""
    n = indptr.shape[0] - 1
    e = indices.shape[0]
    safe = nodes.clamp(0, n - 1).long()
    base = int(window) * max_degree
    start = indptr[safe].long() + base
    deg = (indptr[safe + 1] - indptr[safe]).to(torch.int32)
    rel = deg - base
    offs = torch.arange(max_degree, dtype=torch.int32,
                        device=nodes.device)[None, :]
    mask = (offs < rel[:, None]) & (nodes >= 0)[:, None]
    if e == 0:
        return torch.full(mask.shape, -1, dtype=torch.int32,
                          device=nodes.device), deg
    gather = (start[:, None] + offs).clamp(0, e - 1)
    nbrs = indices[gather].to(torch.int32)
    return torch.where(mask, nbrs, -1), deg


@torch.no_grad()
def layerwise_inference(apply_layer: Callable, indptr, indices,
                        x: torch.Tensor, num_layers: int,
                        batch_size: int = 4096,
                        max_degree: int = 256) -> torch.Tensor:
    """``num_layers`` rounds of exact message passing over every node.

    ``apply_layer(layer_idx, x_self, mean_nbr) -> new_x`` computes one
    layer for a batch from its ``[bs, F]`` own features and the exact
    ``[bs, F]`` mean of all its neighbours' features (zeros for an
    isolated node). ``max_degree`` sets the window width, the size of
    one gather, and truncates nothing. ``indptr``, ``indices`` and ``x``
    lie on one device."""
    n = indptr.shape[0] - 1
    if indptr.dtype == torch.int32 and indices.shape[0] > _INT32_MAX:
        raise ValueError(
            "layerwise_inference: the graph has more edges than an int32 "
            "indptr can address, so its offsets have wrapped; build the "
            "topology with an int64 indptr (CSRTopo widens it itself)")
    host_deg = (indptr[1:] - indptr[:-1]).cpu()
    dev = x.device
    for layer in range(num_layers):
        out = None
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            nodes = torch.full((batch_size,), -1, dtype=torch.int32,
                               device=dev)
            nodes[:hi - lo] = torch.arange(lo, hi, dtype=torch.int32,
                                           device=dev)
            windows = max(1, -(-int(host_deg[lo:hi].max()) // max_degree))
            acc = torch.zeros((batch_size, x.shape[1]), dtype=x.dtype,
                              device=dev)
            for w in range(windows):
                nbrs, _ = neighborhood_block(indptr, indices, nodes,
                                             max_degree, w)
                xn = x.index_select(0, nbrs.clamp(0, n - 1).reshape(-1)) \
                    .view(batch_size, max_degree, x.shape[1])
                xn.masked_fill_((nbrs < 0)[:, :, None], 0)
                acc.add_(xn.sum(dim=1))
            safe = nodes.clamp(0, n - 1).long()
            deg = (indptr[safe + 1] - indptr[safe]).to(x.dtype)
            mean = acc / deg.clamp(min=1.0)[:, None]
            y = apply_layer(layer, x[safe], mean)
            if out is None:
                out = torch.empty((n, y.shape[1]), dtype=y.dtype,
                                  device=dev)
            out[lo:hi] = y[:hi - lo]
        x = out
    return x


def sage_apply_layer(model, activation=torch.relu):
    """``apply_layer`` for a ``GraphSAGE`` (or a sequence of its
    ``SAGEConv``s): ``lin_root(x_self) + lin_nbr(mean)``, ``activation``
    after every layer but the last (no dropout: inference)."""
    convs = list(getattr(model, "convs", model))

    def apply(layer_idx, x_self, mean_nbr):
        conv = convs[layer_idx]
        h = conv.lin_root(x_self) + conv.lin_nbr(mean_nbr)
        return activation(h) if layer_idx < len(convs) - 1 else h
    return apply
