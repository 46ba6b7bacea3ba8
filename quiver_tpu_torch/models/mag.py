"""The MAG240M benchmark model: a GAT or GraphSAGE trunk with skip
connections, norm, and an MLP head (counterpart of
``quiver_tpu/models/mag.py``).

Per hop a conv (the GAT variant adds a skip ``Linear`` of the targets),
LayerNorm, ELU (GAT) or ReLU (GraphSAGE), dropout; then ``mlp0`` ->
``mlp_norm`` -> ReLU -> dropout -> ``mlp1``. LayerNorm stands in for the
reference's BatchNorm1d, as in the flax model, with flax's epsilon 1e-6.
flax computes the variance as E[x^2] - E[x]^2 and torch as E[(x -
E[x])^2]; the two round differently, which the tests allow for. Unlike
the flax model, which infers it, the input width is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .gat import GATConv
from .sage import SAGEConv, dropout

LN_EPS = 1e-6                    # flax nn.LayerNorm's default epsilon


class MAG240MGNN(nn.Module):
    """``model`` is ``"graphsage"`` or ``"gat"`` (``heads`` heads of
    ``hidden_dim // heads`` joined). Dropout acts in train mode only
    (``model.train()``), from the ``generator`` passed to ``forward``."""

    def __init__(self, model: str, in_dim: int, hidden_dim: int,
                 out_dim: int, num_layers: int, heads: int = 4,
                 dropout: float = 0.5):
        super().__init__()
        if model not in ("graphsage", "gat"):
            raise ValueError(f"unknown model {model!r}")
        self.model = model
        convs, skips, norms, width = [], [], [], in_dim
        for _ in range(num_layers):
            if model == "gat":
                convs.append(GATConv(width, hidden_dim // heads,
                                     heads=heads, concat=True))
                skips.append(nn.Linear(width, hidden_dim))
            else:
                convs.append(SAGEConv(width, hidden_dim))
            norms.append(nn.LayerNorm(hidden_dim, eps=LN_EPS))
            width = hidden_dim
        self.convs = nn.ModuleList(convs)
        self.skips = nn.ModuleList(skips)
        self.norms = nn.ModuleList(norms)
        self.mlp0 = nn.Linear(hidden_dim, hidden_dim)
        self.mlp_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.mlp1 = nn.Linear(hidden_dim, out_dim)
        self.dropout = float(dropout)

    def _drop(self, x, generator):
        return dropout(x, self.dropout, generator) if self.training else x

    def forward(self, x, adjs, generator=None):
        for i, adj in enumerate(adjs):
            x_target = x[:adj.size[1]]
            h = self.convs[i](x, x_target, adj.edge_index)
            if self.model == "gat":
                h = F.elu(self.norms[i](h + self.skips[i](x_target)))
            else:
                h = torch.relu(self.norms[i](h))
            x = self._drop(h, generator)
        h = torch.relu(self.mlp_norm(self.mlp0(x)))
        return self.mlp1(self._drop(h, generator))
