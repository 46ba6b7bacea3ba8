"""GAT over the static-shape masked layer format (counterpart of
``quiver_tpu/models/gat.py``; the "GAT on ogbn-products with
attention-weighted neighbour sampling" configuration).

The edge softmax is a masked segment softmax: invalid (-1) edges get a
``-1e30`` logit and no mass, so padding never takes attention. Messages
are read with ``index_select`` and summed with ``index_add_`` (as in
``models/sage.py``: the backward of ``w_src[s]`` sums each row's
duplicates in series, and every invalid edge reads row 0), so logits
agree with the flax model to a float tolerance, not bit for bit. All
heads are computed at once where flax loops over them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .sage import dropout

NEG_INF = -1e30


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, valid: torch.Tensor) -> torch.Tensor:
    """Softmax of ``logits`` (``[E]`` or ``[E, h]``) over the edges of
    each segment, masked edges excluded. A segment with no valid edge
    gets no mass; an empty segment's max (-inf) is taken as 0.

    The shift by the segment max is held constant (detached): softmax
    does not depend on it, so the gradient is the same."""
    logits = torch.where(valid, logits, NEG_INF)
    idx = segment_ids.long()
    if logits.dim() > 1:
        idx = idx[:, None].expand_as(logits)
    seg_max = logits.new_full((num_segments,) + logits.shape[1:],
                              float("-inf")).scatter_reduce(
        0, idx, logits.detach(), "amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = torch.where(valid, logits - seg_max.gather(0, idx), NEG_INF)
    expd = torch.where(valid, torch.exp(shifted), 0.0)
    denom = torch.zeros_like(seg_max).index_add_(0, segment_ids.long(), expd)
    return expd / denom.gather(0, idx).clamp(min=1e-16)


class GATConv(nn.Module):
    """One attention layer, ``heads`` heads of width ``out_dim``, no bias
    (flax's ``GATConv``): per edge ``s -> t`` and head, the logit
    ``leaky_relu(<W_src x_s, a_src> + <W_dst x_t, a_dst>)``, a segment
    softmax over ``t``'s edges, and the attention-weighted sum of the
    ``W_src x_s``. ``concat`` joins the heads, else averages them."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2):
        super().__init__()
        self.heads, self.out_dim = int(heads), int(out_dim)
        self.concat = bool(concat)
        self.negative_slope = float(negative_slope)
        hf = self.heads * self.out_dim
        self.lin_src = nn.Linear(in_dim, hf, bias=False)
        self.lin_dst = nn.Linear(in_dim, hf, bias=False)
        self.att_src = nn.Parameter(torch.empty(self.heads, self.out_dim))
        self.att_dst = nn.Parameter(torch.empty(self.heads, self.out_dim))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)

    def forward(self, x_src, x_dst, edge_index):
        h, f = self.heads, self.out_dim
        t = x_dst.shape[0]
        src, dst = edge_index[0].long(), edge_index[1].long()
        valid = (src >= 0) & (dst >= 0)
        s = torch.where(valid, src, 0)
        d = torch.where(valid, dst, 0)
        w_src = self.lin_src(x_src).reshape(-1, h, f)
        w_dst = self.lin_dst(x_dst).reshape(-1, h, f)
        alpha_src = (w_src * self.att_src).sum(-1)            # [S, h]
        alpha_dst = (w_dst * self.att_dst).sum(-1)            # [T, h]
        logits = F.leaky_relu(alpha_src.index_select(0, s)
                              + alpha_dst.index_select(0, d),
                              self.negative_slope)            # [E, h]
        a = segment_softmax(logits, d, t, valid[:, None])
        msgs = w_src.index_select(0, s) * a[:, :, None]       # [E, h, f]
        out = w_src.new_zeros((t, h, f)).index_add_(0, d, msgs)
        return out.reshape(t, h * f) if self.concat else out.mean(dim=1)


class GAT(nn.Module):
    """Layer-wise minibatch GAT (PyG NeighborSampler pattern:
    ``x_target = x[:size[1]]`` per hop, adjs outermost first). Hidden
    layers have ``heads`` heads of ``hidden_dim`` joined, then ELU and
    dropout; the last layer one head of ``out_dim``. Unlike the flax
    model, which infers it, the input width is given. Dropout acts in
    train mode only (``model.train()``), from the ``generator`` passed
    to ``forward``, so ``forward(x, adjs, generator=None)`` is
    ``GraphSAGE``'s and the train and serve steps take either model."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, heads: int = 4, dropout: float = 0.5):
        super().__init__()
        convs, width = [], in_dim
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(GATConv(width, out_dim if last else hidden_dim,
                                 heads=1 if last else heads,
                                 concat=not last))
            width = hidden_dim * heads
        self.convs = nn.ModuleList(convs)
        self.dropout = float(dropout)

    def forward(self, x, adjs, generator=None):
        last = len(self.convs) - 1
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, x[:adj.size[1]], adj.edge_index)
            if i != last:
                x = F.elu(x)
                if self.training:
                    x = dropout(x, self.dropout, generator)
        return x
