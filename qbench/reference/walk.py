"""The fused walk worked out again in plain PyTorch.

A frozen copy of the sampler's arithmetic: the counter-hash stream of
the CUDA kernels (a Wang-style 32-bit finalizer, seed ``s`` drawing as
lane ``s % 128`` of block ``s // 128``), the partial Fisher-Yates draw
of ``min(deg, k)`` distinct positions among a row's first ``row_cap``
slots, and the compaction between hops: the valid seeds keep slots
``[0, v)`` and every other distinct pick follows in ascending id order.

It imports nothing of the program: the arithmetic is copied, so a later
change to the program's sampler is judged against this copy.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

BLOCK = 128
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_LANE_SALT = 0x85EBCA6B


def mix_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finalizer on int64 tensors that hold uint32 values."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    return x ^ (x >> 15)


def block_base(seed: int, blk: torch.Tensor) -> torch.Tensor:
    """A 128-seed block's stream base; ``seed`` is an int32."""
    return mix_u32((int(seed) & _M32) ^ ((_GOLDEN * (blk + 1)) & _M32))


def rand_bits(base: torch.Tensor, lane: torch.Tensor, step: int):
    """Draw number ``step`` of each lane, uint32 values in int64."""
    x = base ^ ((lane * _LANE_SALT) & _M32) ^ ((step * _GOLDEN) & _M32)
    return mix_u32(mix_u32(x))


def fy_positions(deg: torch.Tensor, k: int, row_cap: int, seed: int):
    """``[bs, k]`` distinct positions in ``[0, min(deg, row_cap))`` by a
    partial Fisher-Yates shuffle with a k-entry write log."""
    bs = deg.shape[0]
    dev = deg.device
    sidx = torch.arange(bs, dtype=torch.int64, device=dev)
    base = block_base(seed, sidx // BLOCK)
    lane = sidx % BLOCK
    pool = deg.long().clamp(max=row_cap)
    pos_log = torch.full((bs, k), -1, dtype=torch.int64, device=dev)
    val_log = torch.zeros((bs, k), dtype=torch.int64, device=dev)
    steps = torch.arange(k, dtype=torch.int64, device=dev)

    def read(x):
        hit = pos_log == x[:, None]
        last = torch.where(hit, steps, -1).amax(dim=1)
        logged = val_log.gather(1, last.clamp(min=0)[:, None])[:, 0]
        return torch.where(last >= 0, logged, x)

    out = []
    for i in range(k):
        j = i + rand_bits(base, lane, i) % (pool - i).clamp(min=1)
        a_j = read(j)
        a_i = read(torch.full_like(j, i))
        out.append(a_j)
        pos_log[:, i] = j
        val_log[:, i] = a_i
    return torch.stack(out, dim=1)


def sample_hop(indptr, indices, seeds, k: int, seed: int, row_cap: int):
    """One hop: ``(nbrs [bs, k] int64 with -1 fill, counts [bs])``.
    A -1 seed has degree 0."""
    valid = seeds >= 0
    p = seeds.long().clamp(min=0)
    start = torch.where(valid, indptr[p].long(), 0)
    deg = torch.where(valid, indptr[p + 1].long() - indptr[p].long(), 0)
    counts = deg.clamp(max=k)
    pos = fy_positions(deg, k, row_cap, seed)
    take = torch.arange(k, device=seeds.device)[None, :] < counts[:, None]
    at = torch.where(take, start[:, None] + pos, 0)
    nbrs = torch.where(take, indices[at].long(), -1)
    return nbrs, counts


class Layer(NamedTuple):
    n_id: torch.Tensor    # [s + s*k] int64, -1 fill
    row: torch.Tensor     # [s*k] target slot of each pick, -1 fill
    col: torch.Tensor     # [s*k] source slot of each pick, -1 fill


def compact(seeds: torch.Tensor, nbrs: torch.Tensor) -> Layer:
    """The frontier after a hop. ``seeds`` hold distinct valid ids first
    and -1 after; they keep their slots, the other distinct picks follow
    in ascending order."""
    s, k = nbrs.shape
    dev = seeds.device
    seeds = seeds.long()
    v = int((seeds >= 0).sum())
    seed_ids = seeds[:v]
    flat = nbrs.reshape(-1).long()
    live = flat >= 0
    order = torch.argsort(seed_ids)
    sorted_seeds = seed_ids[order]
    at = torch.searchsorted(sorted_seeds, flat).clamp(max=max(v - 1, 0))
    if v:
        is_seed = live & (sorted_seeds[at] == flat)
    else:
        is_seed = torch.zeros_like(live)
    new = torch.unique(flat[live & ~is_seed])
    n_id = torch.full((s + s * k,), -1, dtype=torch.int64, device=dev)
    n_id[:v] = seed_ids
    n_id[v:v + new.numel()] = new
    slot_new = v + torch.searchsorted(new, flat)
    col = torch.where(is_seed, order[at] if v else at, slot_new)
    col = torch.where(live, col, -1)
    row = torch.arange(s, device=dev)[:, None].expand(s, k).reshape(-1)
    row = torch.where(live, row, -1)
    return Layer(n_id, row, col)


class Hop(NamedTuple):
    seeds: torch.Tensor   # the hop's seeds, -1 fill
    nbrs: torch.Tensor    # [s, k] picks, -1 fill
    counts: torch.Tensor  # [s] picks a seed
    layer: Layer          # the compacted frontier


def walk(indptr, indices, seeds, sizes: Sequence[int],
         hop_seeds: Sequence[int], row_cap: int) -> List[Hop]:
    """Every hop of the fanout ladder, each compacted into the next
    hop's seeds. The last hop's ``layer.n_id`` is the whole frontier."""
    hops = []
    cur = seeds.long()
    for k, s in zip(sizes, hop_seeds):
        nbrs, counts = sample_hop(indptr, indices, cur, int(k), int(s),
                                  row_cap)
        hops.append(Hop(cur, nbrs, counts, compact(cur, nbrs)))
        cur = hops[-1].layer.n_id
    return hops


def blocks(hops: Sequence[Hop], caps: Sequence[int]):
    """The model's blocks, outermost hop first: ``(edge_index [2, E]
    (source slot, target slot), (source capacity, target capacity))``."""
    out = [(torch.stack([h.layer.col, h.layer.row]), (caps[i + 1], caps[i]))
           for i, h in enumerate(hops)]
    return out[::-1]
