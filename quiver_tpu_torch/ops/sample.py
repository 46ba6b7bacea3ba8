"""The exact sampler and layer compaction (counterpart of
``sample_layer`` and the compaction half of ``quiver_tpu/ops/sample.py``).

``sample_layer`` draws ``min(deg, k)`` distinct neighbours per seed,
uniformly without replacement, by a vectorised partial Fisher–Yates
from an explicit ``torch.Generator``. It is plain torch, on the card as
on the CPU: the JAX function is ``jnp`` code, not a Pallas kernel. The
two packages' random streams differ, so it is held to the JAX package by
contract (membership, counts, distinct picks, uniformity), not bit for
bit.

``compact_layer`` dedups a hop's ``concat(seeds, picks)`` into the next
frontier and emits the hop's bipartite COO in local ids. The order is
the JAX package's, bit for bit: valid seeds keep slots ``[0, v)`` and
the other unique ids follow in ascending order. It is built from one
sort, prefix scans and scatters of static size, so it needs no host
synchronisation on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_I32_MAX = 2**31 - 1
_B30 = 1 << 30


class LayerSample(NamedTuple):
    """One sampled hop, fixed shapes.

    n_id:       [cap] unique node ids (valid seeds first, keeping their
                slots; then new neighbours in ascending id order; -1 fill
                past ``n_count``)
    n_count:    [] number of valid entries in ``n_id``
    row:        [num_seeds*k] local index of the seed of each sampled
                edge; -1 fill
    col:        [num_seeds*k] local index of the sampled neighbour; -1 fill
    edge_count: [] number of valid sampled edges
    e_id:       [num_seeds*k] global edge ids when tracked, else None
    """

    n_id: torch.Tensor
    n_count: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    edge_count: torch.Tensor
    e_id: Optional[torch.Tensor] = None


def _fisher_yates_rows(generator: torch.Generator, deg: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Per row, draw ``min(deg, k)`` distinct positions in ``[0, deg)``.

    A virtual array ``a = [0..deg)`` per row; step ``i`` swaps ``a[i]``
    with ``a[j]``, ``j ~ U[i, deg)``, and emits ``a[j]``. Only the <= k
    written entries are kept (a write log), so the cost is O(bs * k^2)
    whatever the degree. ``j`` is a 62-bit draw modulo the span: the
    bias is below 2**-48 for any degree an int32 graph has.

    Returns positions ``[bs, k]`` (int64); slots ``i >= min(deg, k)``
    are meaningless and must be masked by the caller."""
    bs = deg.shape[0]
    dev = deg.device
    deg = deg.to(torch.int64)
    steps = torch.arange(k, dtype=torch.int64, device=dev)
    pos_log = torch.full((bs, k), -1, dtype=torch.int64, device=dev)
    val_log = torch.zeros((bs, k), dtype=torch.int64, device=dev)
    draws = torch.randint(0, 2**62, (k, bs), generator=generator,
                          device=dev, dtype=torch.int64)

    def lookup(x):
        # virtual read a[x]: the last write wins; unwritten -> x itself
        match = pos_log == x[:, None]
        last = torch.where(match, steps, -1).amax(dim=1)
        logged = val_log.gather(1, last.clamp(min=0)[:, None])[:, 0]
        return torch.where(last >= 0, logged, x)

    picks = []
    for i in range(k):
        span = (deg - i).clamp(min=1)
        j = i + draws[i] % span
        a_j = lookup(j)
        a_i = lookup(torch.full((bs,), i, dtype=torch.int64, device=dev))
        pos_log[:, i] = j
        val_log[:, i] = a_i
        picks.append(a_j)
    return torch.stack(picks, dim=1)


def sample_layer(indptr: torch.Tensor, indices: torch.Tensor,
                 seeds: torch.Tensor, k: int, generator: torch.Generator,
                 with_slots: bool = False):
    """Sample up to ``k`` distinct neighbours of each seed, all of a
    seed's neighbours being candidates (no ``row_cap`` window).

    ``seeds`` may hold -1 (masked rows). Returns ``(nbrs [bs, k] int32
    with -1 fill, counts [bs] int32)`` with ``counts == min(deg, k)``;
    with ``with_slots`` also each pick's CSR slot (``[bs, k]``, -1
    fill). ``generator`` lives on the seeds' device."""
    n = indptr.shape[0] - 1
    e = indices.shape[0]
    valid = seeds >= 0
    safe = seeds.long().clamp(0, max(n - 1, 0))
    start = indptr[safe].long()
    deg = torch.where(valid, indptr[safe + 1].long() - start, 0)
    counts = deg.clamp(max=k).to(torch.int32)
    picks = _fisher_yates_rows(generator, deg, k)
    slot = (start[:, None] + picks).clamp(0, max(e - 1, 0))
    mask = torch.arange(k, device=seeds.device)[None, :] < counts[:, None]
    nbrs = indices[slot].to(torch.int32) if e else \
        torch.zeros_like(slot, dtype=torch.int32)
    nbrs = torch.where(mask, nbrs, -1)
    if with_slots:
        return nbrs, counts, torch.where(mask, slot, -1)
    return nbrs, counts


def _compact_core(ids: torch.Tensor, s: int, seeds_dense: bool = False):
    """Sort-based compaction. ``ids[:s]`` is the seed prefix: its valid
    entries must be distinct and take slots by rank among valid seeds
    (by position with ``seeds_dense``, which promises they are exactly
    the prefix ``[0, v)``). Returns ``(n_id [cap] -1 filled, n_count,
    local [cap])`` with ``local[i]`` the slot of ``ids[i]`` (garbage
    where ``ids[i] < 0``, the same garbage as the JAX package's)."""
    cap = ids.shape[0]
    dev = ids.device
    ids = ids.to(torch.int64)
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    valid = ids >= 0
    is_seed = (iota < s) & valid
    idk = torch.where(valid, ids, _I32_MAX)
    # one int64 key = (id, tag): a run's seed entry sorts first, and the
    # low bits of the tag carry the original position; keys are unique
    tag = torch.where(is_seed, 0, _B30) | iota
    skey, _ = torch.sort((idk << 31) | tag)
    sid = skey >> 31
    stag = skey & ((1 << 31) - 1)
    spos = stag & (_B30 - 1)
    sseed = stag < _B30
    if seeds_dense:
        srk = spos
    else:
        seed_rank = torch.cumsum(is_seed, 0) - 1
        srk = torch.where(is_seed, seed_rank, 0)[spos]

    flag = torch.ones(cap, dtype=torch.bool, device=dev)
    flag[1:] = sid[1:] != sid[:-1]
    fvalid = sid != _I32_MAX
    vseeds = is_seed.sum()
    nsflag = flag & fvalid & ~sseed           # valid non-seed run starts

    # each element's run start ``rs``: the JAX package fills it with a
    # cummax; here the run starts are scattered by run number and read
    # back, because torch's cummax was the largest device cost of a
    # served batch on the card (PERF.md). A run's first entry is its
    # seed, if it has one, so the run is a seed run exactly when its
    # start is a seed.
    run_id = torch.cumsum(flag, 0) - 1
    starts = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    starts.index_copy_(0, torch.where(flag, run_id, cap), iota)
    rs = starts[run_id]
    in_seedrun = sseed[rs]
    nsrank = torch.cumsum(nsflag, 0) - 1
    local_sorted = torch.where(in_seedrun, srk[rs], vseeds + nsrank)
    n_count = (vseeds + nsflag.sum()).to(torch.int32)

    # run starts scatter their id into their slot; the rest go to a spare
    # slot ``cap`` that is cut off
    n_id = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    n_id.index_copy_(0, torch.where(flag & fvalid, local_sorted, cap), sid)
    local = torch.empty(cap, dtype=torch.int64, device=dev)
    local.index_copy_(0, spos, local_sorted)
    return n_id[:cap].to(torch.int32), n_count, local.to(torch.int32)


def compact_ids(ids: torch.Tensor):
    """Deduplicate a -1-padded id vector: ``(n_id [cap] ascending, -1
    filled, n_count, local [cap])``."""
    return _compact_core(ids, 0, seeds_dense=True)


def compact_layer(seeds: torch.Tensor, nbrs: torch.Tensor,
                  seeds_dense: bool = False) -> LayerSample:
    """Deduplicate ``concat(seeds, nbrs)`` and emit the layer's COO in
    local ids. ``seeds`` [s] int32 (-1 fill; valid entries distinct),
    ``nbrs`` [s, k] int32 (-1 fill). Capacity is the static ``s + s*k``;
    valid seeds keep slots ``[0, v)``. ``seeds_dense`` promises the valid
    seeds are a prefix, as a previous hop's ``n_id`` always is."""
    s, k = nbrs.shape
    flat = nbrs.reshape(-1)
    n_id, n_count, local = _compact_core(
        torch.cat([seeds.to(torch.int32), flat.to(torch.int32)]), s,
        seeds_dense=seeds_dense)
    nbr_valid = flat >= 0
    col = torch.where(nbr_valid, local[s:], -1)
    row = torch.where(nbr_valid,
                      local[:s, None].expand(s, k).reshape(-1), -1)
    edge_count = nbr_valid.sum().to(torch.int32)
    return LayerSample(n_id=n_id, n_count=n_count, row=row, col=col,
                       edge_count=edge_count)
