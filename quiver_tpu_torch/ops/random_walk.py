"""Uniform random walks on the CSR topology (counterpart of
``quiver_tpu/ops/random_walk.py``).

The unsupervised GraphSAGE example draws its positive pairs from 1-step
walks. Each hop is one uniform neighbour pick per walker, read through
``ops/sample.py: take``, so a topology pinned in host memory (the
sampler's HOST mode) is read by the card's gathers. A walker on a
zero-degree node stays where it is (``torch_cluster`` repeats the node
the same way); a -1 walker stays -1. Draws come from an explicit
``torch.Generator`` on the walkers' device, one per walker and hop.
"""

from __future__ import annotations

import torch

from .sample import _segment_heads, _uniform_below, take


def random_walk_step(indptr: torch.Tensor, indices: torch.Tensor,
                     cur: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """One uniform-neighbour hop for every walker. ``cur`` ``[w]`` int32
    (-1 allowed). Returns the next ``[w]`` int32."""
    start, deg = _segment_heads(indptr, cur)
    r = _uniform_below(generator, deg.clamp(min=1))
    moves = deg > 0
    nxt = take(indices, torch.where(moves, start + r, -1)).to(torch.int32)
    nxt = torch.where(moves, nxt, cur.to(torch.int32))
    return torch.where(cur >= 0, nxt, -1)


def random_walk(indptr: torch.Tensor, indices: torch.Tensor,
                starts: torch.Tensor, walk_length: int,
                generator: torch.Generator) -> torch.Tensor:
    """Uniform random walks of ``walk_length`` hops. Returns ``[w,
    walk_length + 1]`` int32 paths, ``paths[:, 0] == starts``."""
    cur = starts.to(torch.int32)
    path = [cur]
    for _ in range(int(walk_length)):
        cur = random_walk_step(indptr, indices, cur, generator)
        path.append(cur)
    return torch.stack(path, dim=1)
