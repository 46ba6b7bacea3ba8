"""GraphSAGE, its loss and Adam, in plain PyTorch.

The layer equations are written out from the published model: GraphSAGE
(Hamilton et al. 2017, mean aggregator), ``h_t' = W_root h_t + b +
W_nbr mean_{s in N(t)} h_s``; ReLU and dropout between layers.

Sampled blocks come as ``(edge_index [2, E], (n_src, n_dst))`` with
``edge_index[0]`` the source slot, ``edge_index[1]`` the target slot and
-1 on padded edges; the targets are the first ``n_dst`` rows of the
sources. Dropout draws its keep-mask as ``torch.rand(shape,
generator=g) < 1 - p`` from one ``torch.Generator`` seeded with the
step's dropout seed on the data's device, in layer order.

Parameters are a dict of plain tensors keyed by the names of the
program's ``state_dict`` (``convs.<i>.lin_root.weight``, ...): the
benchmark makes them from its seed and hands the same values to both.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Block = Tuple[torch.Tensor, Tuple[int, int]]


def _dropout(x, rate: float, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=x.dtype) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _edges(edge_index):
    src, dst = edge_index[0].long(), edge_index[1].long()
    valid = (src >= 0) & (dst >= 0)
    return torch.where(valid, src, 0), torch.where(valid, dst, 0), valid


def sage_forward(p: Dict[str, torch.Tensor], x, blocks: Sequence[Block],
                 dropout: float = 0.0, gen=None):
    last = len(blocks) - 1
    for i, (edge_index, (_, n_dst)) in enumerate(blocks):
        s, d, valid = _edges(edge_index)
        w = valid.to(x.dtype)
        agg = x.new_zeros((n_dst, x.shape[1])).index_add_(
            0, d, x.index_select(0, s) * w[:, None])
        cnt = x.new_zeros((n_dst,)).index_add_(0, d, w)
        mean = agg / cnt.clamp(min=1.0)[:, None]
        pre = f"convs.{i}."
        x = x[:n_dst] @ p[pre + "lin_root.weight"].t() \
            + p[pre + "lin_root.bias"] + mean @ p[pre + "lin_nbr.weight"].t()
        if i != last:
            x = torch.relu(x)
            if gen is not None:
                x = _dropout(x, dropout, gen)
    return x


def loss_and_grads(forward, params: Dict[str, torch.Tensor], x, blocks,
                   labels, batch: int, dropout_seed: int, **kw):
    """The mean cross-entropy over the first ``batch`` rows and every
    parameter's gradient, with dropout drawn from ``dropout_seed``."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in params.items()}
    gen = torch.Generator(device=x.device).manual_seed(int(dropout_seed))
    logits = forward(leaves, x, blocks, gen=gen, **kw)[:batch]
    loss = F.cross_entropy(logits, labels.long())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


class Adam:
    """Adam (Kingma and Ba 2015) with the bias corrections and ``eps``
    added outside the square root, as ``torch.optim.Adam`` defines it."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p = {n: t.detach().clone() for n, t in params.items()}
        self.m = {n: torch.zeros_like(t) for n, t in self.p.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.p.items()}
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for n, g in grads.items():
            self.m[n] = self.b1 * self.m[n] + (1 - self.b1) * g
            self.v[n] = self.b2 * self.v[n] + (1 - self.b2) * g * g
            den = (self.v[n] / c2).sqrt() + self.eps
            self.p[n] = self.p[n] - self.lr * (self.m[n] / c1) / den


def train_steps(forward, params, steps: List[dict], lr: float, batch: int,
                **kw):
    """Run the reference over ``steps`` (each ``{"x", "blocks", "labels",
    "dropout_seed"}``). Returns the losses, the first step's gradients
    and the parameters after the last step."""
    opt = Adam(params, lr)
    losses, first = [], None
    for st in steps:
        loss, g = loss_and_grads(forward, opt.p, st["x"], st["blocks"],
                                 st["labels"], batch, st["dropout_seed"],
                                 **kw)
        losses.append(float(loss))
        if first is None:
            first = g
        opt.step(g)
    return losses, first, opt.p
