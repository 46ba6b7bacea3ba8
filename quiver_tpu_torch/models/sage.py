"""GraphSAGE over the static-shape masked layer format (counterpart of
``quiver_tpu/models/sage.py``).

Message passing is a masked mean: -1-filled (invalid) edges contribute
nothing because their mask zeroes the message and the count. Sums use
``index_add_``, whose order on the card follows its atomics, so logits
agree with the JAX model to a float tolerance, not bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn


def masked_mean_aggregate(x_src: torch.Tensor, edge_index: torch.Tensor,
                          num_targets: int) -> torch.Tensor:
    """Mean of neighbour features per target node. ``edge_index`` [2, E]
    with row 0 = source local id, row 1 = target local id, -1 fill."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    valid = (src >= 0) & (dst >= 0)
    s = torch.where(valid, src, 0)
    d = torch.where(valid, dst, 0)
    w = valid.to(x_src.dtype)
    # index_select, not x_src[s]: every invalid edge reads row 0, and the
    # backward of advanced indexing sums each row's duplicates in series
    # (24 ms of a 35 ms train step on the card); index_select's backward
    # is an index_add_
    msg = x_src.index_select(0, s) * w[:, None]
    agg = x_src.new_zeros((num_targets, x_src.shape[1])).index_add_(0, d, msg)
    cnt = x_src.new_zeros((num_targets,)).index_add_(0, d, w)
    return agg / torch.clamp(cnt, min=1.0)[:, None]


class SAGEConv(nn.Module):
    """h_t' = W_root h_t + W_nbr mean_{s in N(t)} h_s"""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.lin_root = nn.Linear(in_dim, out_dim, bias=bias)
        self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x_src, x_dst, edge_index):
        mean_nbr = masked_mean_aggregate(x_src, edge_index, x_dst.shape[0])
        return self.lin_root(x_dst) + self.lin_nbr(mean_nbr)


class RowKeyedDropout:
    """Dropout masks keyed by row, passed as a model's ``generator``:
    the ``j``-th dropout of a forward keeps value ``(r, c)`` by the
    counter hash of ``(seed, rows[j][r], j, c)``, so a node's mask at a
    layer does not depend on its row in the block. ``rows[j]`` are the
    node ids of the rows the ``j``-th dropout sees (for ``GraphSAGE``,
    the targets of ``adjs[j]``; -1 rows are keyed as id ``2**32 - 1``).
    One object serves one forward."""

    def __init__(self, seed: int, rows):
        self.seed = int(seed)
        self.rows = list(rows)
        self.calls = 0

    def keep(self, shape, keep_prob: float) -> torch.Tensor:
        from ..ops.kernels._rng import BLOCK, block_base, rand_bits
        j = self.calls
        self.calls += 1
        node = self.rows[j].to(torch.int64)[:shape[0]] & 0xFFFFFFFF
        base = block_base(self.seed, node // BLOCK)[:, None]
        lane = (node % BLOCK)[:, None]
        col = torch.arange(shape[1], dtype=torch.int64, device=node.device)
        bits = rand_bits(base, lane, (j << 16) + col[None, :])
        return bits < int(keep_prob * 2**32)


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """flax's ``nn.Dropout`` in train mode: keep each value with
    probability ``1 - rate`` and scale the kept ones by ``1 / (1 -
    rate)``. The keep-mask is drawn from ``generator`` (a
    ``torch.Generator`` on ``x``'s device; ``None`` takes torch's
    default one; or a :class:`RowKeyedDropout`), never from a hidden
    global stream the caller cannot seed."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = generator.keep(x.shape, keep_prob) \
        if hasattr(generator, "keep") else \
        torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class GraphSAGE(nn.Module):
    """Layer-wise minibatch GraphSAGE (PyG NeighborSampler pattern:
    ``x_target = x[:size[1]]`` per hop, adjs outermost first). Unlike the
    flax model, which infers it, the input width is given. Dropout acts
    in train mode only (``model.train()``), from the ``generator``
    passed to ``forward``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, dropout: float = 0.5):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1]) for i in range(num_layers))
        self.dropout = float(dropout)

    def forward(self, x, adjs, generator=None):
        last = len(self.convs) - 1
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, x[:adj.size[1]], adj.edge_index)
            if i != last:
                x = torch.relu(x)
                if self.training:
                    x = dropout(x, self.dropout, generator)
        return x
