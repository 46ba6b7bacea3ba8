"""Relational GCN over heterogeneous sampled layers (counterpart of
``quiver_tpu/models/rgcn.py``): per relation a masked mean and a weight
matrix without bias, summed into the destination type, plus a per-type
self transform with bias.

It takes ``HeteroLayer`` hops from ``hetero.py`` (outermost first).
Each type's frontier starts with the frontier before the hop, so the PyG
pattern ``x_target = x[:cap]`` holds per type. Relations are summed in
the order of ``adjs`` (the sampler's: sorted, as JAX's jitted sampler
returns them). Unlike the flax model, which infers them, the input
widths and each layer's relations are given.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .sage import dropout, masked_mean_aggregate


def rel_name(et) -> str:
    """The flax module name of relation ``et``'s weight."""
    src, rel, dst = et
    return f"rel__{src}__{rel}__{dst}"


class RGCNConv(nn.Module):
    """One R-GCN layer over the relations ``edge_types``: ``in_dims``
    maps each node type to its input width."""

    def __init__(self, in_dims: Dict[str, int], out_dim: int,
                 edge_types: Sequence):
        super().__init__()
        self.out_dim = int(out_dim)
        dsts = []
        for et in edge_types:
            self.add_module(rel_name(et), nn.Linear(in_dims[et[0]],
                                                    out_dim, bias=False))
            if et[2] not in dsts:
                dsts.append(et[2])
        for dst in dsts:
            self.add_module(f"self__{dst}", nn.Linear(in_dims[dst], out_dim))

    def forward(self, x: Dict[str, torch.Tensor], adjs: Dict[tuple, object]):
        agg: Dict[str, torch.Tensor] = {}
        dst_cap: Dict[str, int] = {}
        for et, adj in adjs.items():
            src_t, _, dst_t = et
            mean = masked_mean_aggregate(x[src_t], adj.edge_index,
                                         adj.size[1])
            h = getattr(self, rel_name(et))(mean)
            agg[dst_t] = agg[dst_t] + h if dst_t in agg else h
            dst_cap[dst_t] = adj.size[1]
        return {dst_t: getattr(self, f"self__{dst_t}")(
                    x[dst_t][:dst_cap[dst_t]]) + msg
                for dst_t, msg in agg.items()}


class RGCN(nn.Module):
    """Multi-hop R-GCN returning the seed type's logits.
    ``edge_types[i]`` lists layer i's relations (``list(layers[i].adjs)``
    of a sample); hidden layers are
    followed by ReLU and dropout, which acts in train mode only
    (``model.train()``), drawn from the ``generator`` passed to
    ``forward``."""

    def __init__(self, in_dims: Dict[str, int], hidden_dim: int,
                 out_dim: int, num_layers: int, seed_type: str,
                 edge_types: Sequence[Sequence], dropout: float = 0.5):
        super().__init__()
        if len(edge_types) != num_layers:
            raise ValueError(f"edge_types lists {len(edge_types)} layers, "
                             f"the model has {num_layers}")
        convs, dims = [], dict(in_dims)
        for i in range(num_layers):
            dim = out_dim if i == num_layers - 1 else hidden_dim
            convs.append(RGCNConv(dims, dim, edge_types[i]))
            dims = {t: hidden_dim for t in dims}
        self.convs = nn.ModuleList(convs)
        self.seed_type = seed_type
        self.dropout = float(dropout)

    def forward(self, x, hetero_layers, generator=None):
        last = len(self.convs) - 1
        for i, (conv, layer) in enumerate(zip(self.convs, hetero_layers)):
            x = conv(x, layer.adjs)
            if i != last:
                x = {t: torch.relu(v) for t, v in x.items()}
                if self.training:
                    x = {t: dropout(v, self.dropout, generator)
                         for t, v in x.items()}
        return x[self.seed_type]
