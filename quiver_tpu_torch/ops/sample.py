"""Neighbour sampling and layer compaction (counterpart of
``quiver_tpu/ops/sample.py``).

Samplers, all plain torch, on the card as on the CPU (the JAX functions
are ``jnp`` code, not Pallas kernels), drawing from an explicit
``torch.Generator``:

- ``sample_layer``: ``min(deg, k)`` distinct neighbours per seed,
  uniformly without replacement, by a vectorised partial Fisher–Yates;
- ``sample_layer_exact_wide``: the same draw (bit for bit, for the same
  generator state) read through a rows view of ``indices``: one or two
  row reads per seed whose segment fits its window, scattered reads only
  for hub rows, up to a static budget, the overflow predicated on the
  card;
- ``sample_layer_rotation`` and ``sample_layer_window``: a consecutive
  run, or an i.i.d. subset of a window, of a row order that is
  reshuffled every epoch (``reshuffle_csr``: ``permute_csr``'s stable
  sort or ``butterfly_shuffle``'s swap network), read through the rows
  views ``as_index_rows`` (pair) or ``as_index_rows_overlapping``.

Every sampler reads the topology through :func:`take` (scattered
reads) and :func:`take_segments` (each seed's span of consecutive
elements: its ``indptr`` heads, the weighted pool's weights): plain
indexing when the topology lies on the seeds' device (HBM mode, or the
CPU), the card's gather kernels (``ops/kernels/gather.py``) when it lies
in pinned host memory and the seeds on a card (HOST mode). Both run the
same tensor ops on the same draws, so both give the same picks.

The two packages' random streams differ, so the samplers are held to
the JAX package by contract (membership, counts, distinct picks,
uniformity); every deterministic stage (layouts, compaction, the bucket
split, probabilities) is held to it on the same inputs.

``compact_layer`` dedups a hop's ``concat(seeds, picks)`` into the next
frontier and emits the hop's bipartite COO in local ids. The order is
the JAX package's, bit for bit: valid seeds keep slots ``[0, v)`` and
the other unique ids follow in ascending order. It is built from one
sort, prefix scans and scatters of static size, so it needs no host
synchronisation on the card.
"""

from __future__ import annotations

import math
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


class StreamDraws:
    """The draws of one ``torch.Generator``'s stream, taken in the order
    the samplers ask for them (the split route's draws). With
    :class:`KeyedDraws` it is the one interface every sampler draws
    through: ``offsets`` (a windowed sampler's anchors), ``positions``
    (one ``_fisher_yates_rows``) and ``uniforms`` (one weighted hop);
    ``hop`` gives a walk's hop its draws (the same stream) and ``stream``
    the generator a per-call shuffle draws from."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def offsets(self, bs: int, device) -> torch.Tensor:
        return torch.randint(0, 2**62, (bs,), generator=self.generator,
                             device=device, dtype=torch.int64)

    def positions(self, bs: int, k: int, device) -> torch.Tensor:
        return torch.randint(0, 2**62, (k, bs), generator=self.generator,
                             device=device, dtype=torch.int64)

    def uniforms(self, bs: int, k: int, device) -> torch.Tensor:
        return torch.rand((bs, k), generator=self.generator, device=device,
                          dtype=torch.float32)

    def hop(self, i: int, ids: torch.Tensor) -> "StreamDraws":
        return self

    def stream(self) -> Optional[torch.Generator]:
        return self.generator


class KeyedDraws:
    """Draws keyed by node id: row ``b``'s draws are a function of
    ``(seed, ids[b], draw number)`` only, the kernels' counter hash
    (``kernels/_rng.py``) with ``blk`` and ``lane`` taken from the node id
    in place of the row's position. So a node's picks do not depend on
    where it sits in the frontier or on the other rows: a walk over a
    slice of a batch draws, for each of its seeds, the tree the walk over
    the whole batch draws. ``ids`` are the rows' node ids (-1 rows are
    keyed as id ``2**32 - 1``). The unweighted samplers take it as their
    ``generator``."""

    OFFSET_DRAW = 1 << 20          # the anchors' draw number

    def __init__(self, seed: int, ids: torch.Tensor):
        from .kernels._rng import BLOCK, block_base
        node = ids.to(torch.int64) & 0xFFFFFFFF
        self.lane = node % BLOCK
        self.base = block_base(int(seed), node // BLOCK)

    def bits62(self, draw: int) -> torch.Tensor:
        """Draw number ``draw`` of every row: 62 bits in an int64."""
        from .kernels._rng import rand_bits
        hi = rand_bits(self.base, self.lane, 2 * draw) & ((1 << 30) - 1)
        lo = rand_bits(self.base, self.lane, 2 * draw + 1)
        return (hi << 32) | lo

    def offsets(self, bs: int, device) -> torch.Tensor:
        return self.bits62(self.OFFSET_DRAW)

    def positions(self, bs: int, k: int, device) -> torch.Tensor:
        if not k:
            return torch.zeros((0, bs), dtype=torch.int64, device=device)
        return torch.stack([self.bits62(i) for i in range(k)])

    def uniforms(self, bs: int, k: int, device) -> torch.Tensor:
        raise ValueError("keyed draws serve the unweighted samplers only")


def as_draws(source) -> "StreamDraws | KeyedDraws":
    """A sampler's ``generator`` argument as draws: a ``torch.Generator``
    (or None, torch's default stream) becomes its :class:`StreamDraws`;
    a draws object passes through."""
    return source if hasattr(source, "positions") else StreamDraws(source)


def _draw_offsets(generator, bs: int, device) -> torch.Tensor:
    """``bs`` 62-bit draws: a windowed sampler's anchors (reduced modulo
    each span by the caller)."""
    return as_draws(generator).offsets(bs, device)


def _draw_positions(generator, bs: int, k: int, device) -> torch.Tensor:
    """The ``[k, bs]`` 62-bit draws of one ``_fisher_yates_rows``."""
    return as_draws(generator).positions(bs, k, device)


def _uniform_below(generator: torch.Generator,
                   span: torch.Tensor) -> torch.Tensor:
    """Per entry, a draw in ``[0, span)`` (``span >= 1``, int64)."""
    return _draw_offsets(generator, span.shape[0], span.device) % span


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
    draws = _draw_positions(generator, bs, k, dev)

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


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a topology array: ``indptr``, ``indices`` or an
    edge-id map (1-D), or a rows view (2-D). Every sampler reads the
    topology through this one function.

    A negative id is a read the caller does not take; its value is
    unspecified and the caller masks it.

    - The table on the ids' device (HBM mode, or the CPU): plain
      indexing, a negative id clamped to 0, an L2-resident read.
    - The table in pinned host memory and the ids on a card (HOST mode,
      the reference's UVA): the card's gather kernels,
      ``gather_elems`` for a 1-D table and ``gather_rows`` for a rows
      view; a negative id reads nothing.
    - A host table that is not pinned, with ids on a card: raises, as
      does any other pairing."""
    if table.device == ids.device:
        return table[ids.long().clamp(min=0)]
    if ids.device.type != "cuda" or table.device.type != "cpu":
        raise ValueError(f"cannot read a topology array on {table.device} "
                         f"with ids on {ids.device}")
    if not table.is_pinned():
        raise ValueError("the card reads a host topology array only when "
                         "it lies in pinned memory (utils/placement.py: "
                         "pinned_put)")
    from .kernels import gather
    flat = ids.reshape(-1)
    if table.dim() == 1:
        return gather.gather_elems(table, flat).reshape(ids.shape)
    out = torch.empty((flat.shape[0], table.shape[1]), dtype=table.dtype,
                      device=ids.device)
    return gather.gather_rows(table, flat.to(torch.int32), out=out) \
        .reshape(*ids.shape, table.shape[1])


def take_segments(table: torch.Tensor, start: torch.Tensor,
                  count: torch.Tensor, width: int) -> torch.Tensor:
    """``[bs, width]``: per seed, ``table[start[i] + j]`` for ``j <
    count[i]``, the seed's span of consecutive elements of a 1-D
    topology array (``indptr``, edge weights). A column at or past
    ``count`` is a read the caller does not take; its value is
    unspecified and the caller masks it.

    - The table on the seeds' device (HBM mode, or the CPU): plain
      indexing of the ids ``where(j < count, start + j, -1)`` through
      :func:`take`.
    - The table in pinned host memory and the seeds on a card (HOST
      mode): the span kernel, ``gather_segments``, which builds no id
      array and reads nothing past ``count``.
    - Any other pairing raises, as :func:`take` does."""
    if table.device == start.device:
        j = torch.arange(width, device=start.device)[None, :]
        return take(table, torch.where(j < count[:, None],
                                       start[:, None] + j, -1))
    if start.device.type != "cuda" or table.device.type != "cpu":
        raise ValueError(f"cannot read a topology array on {table.device} "
                         f"with spans on {start.device}")
    if not table.is_pinned():
        raise ValueError("the card reads a host topology array only when "
                         "it lies in pinned memory (utils/placement.py: "
                         "pinned_put)")
    from .kernels import gather
    return gather.gather_segments(table, start.long().contiguous(),
                                  count.to(torch.int32).contiguous(), width)


def _segment_heads(indptr: torch.Tensor, seeds: torch.Tensor):
    """Per seed ``(start, deg)``, int64, read in one ``take_segments``
    of both ``indptr`` entries. Invalid (-1) seeds read nothing and get
    start 0 and deg 0, which masks them downstream."""
    n = indptr.shape[0] - 1
    valid = seeds >= 0
    safe = seeds.long().clamp(0, max(n - 1, 0))
    both = take_segments(indptr, safe, torch.where(valid, 2, 0), 2).long()
    start = torch.where(valid, both[:, 0], 0)
    deg = torch.where(valid, both[:, 1] - both[:, 0], 0)
    return start, deg


def _pick_mask(counts: torch.Tensor, k: int) -> torch.Tensor:
    return torch.arange(k, device=counts.device)[None, :] < counts[:, None]


def sample_layer(indptr: torch.Tensor, indices: torch.Tensor,
                 seeds: torch.Tensor, k: int, generator: torch.Generator,
                 with_slots: bool = False):
    """Sample up to ``k`` distinct neighbours of each seed, all of a
    seed's neighbours being candidates (no ``row_cap`` window).

    ``seeds`` may hold -1 (masked rows). Returns ``(nbrs [bs, k] int32
    with -1 fill, counts [bs] int32)`` with ``counts == min(deg, k)``;
    with ``with_slots`` also each pick's CSR slot (``[bs, k]``, -1
    fill). ``generator`` lives on the seeds' device; the topology lies
    there or in pinned host memory (:func:`take`)."""
    e = indices.shape[0]
    start, deg = _segment_heads(indptr, seeds)
    counts = deg.clamp(max=k).to(torch.int32)
    picks = _fisher_yates_rows(generator, deg, k)
    slot = (start[:, None] + picks).clamp(0, max(e - 1, 0))
    mask = _pick_mask(counts, k)
    nbrs = take(indices, torch.where(mask, slot, -1)).to(torch.int32) \
        if e else torch.zeros_like(slot, dtype=torch.int32)
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


def compact_union(prefix_ids: torch.Tensor, extra_ids: torch.Tensor):
    """Union ``prefix_ids ++ extra_ids`` (both -1 padded, any lengths).
    Valid prefix entries (distinct) keep their slots in ``n_id``; the
    other unique extras follow in ascending id order. Returns ``(n_id,
    n_count, local ids of the extras)``."""
    p = prefix_ids.shape[0]
    n_id, n_count, local = _compact_core(
        torch.cat([prefix_ids.to(torch.int32), extra_ids.to(torch.int32)]),
        p)
    return n_id, n_count, torch.where(extra_ids >= 0, local[p:], -1)


# -- row ids and rows views -------------------------------------------------

def edge_row_ids(indptr: torch.Tensor, edge_count: int) -> torch.Tensor:
    """Row id of every CSR slot (int32), by one scatter-add of the row
    starts and a prefix sum."""
    dev = indptr.device
    if edge_count == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    inner = indptr[1:-1].long()
    z = torch.zeros(edge_count, dtype=torch.int32, device=dev)
    z.index_add_(0, inner.clamp(0, edge_count - 1),
                 (inner < edge_count).to(torch.int32))
    return torch.cumsum(z, 0, dtype=torch.int32)


def edge_rows(indptr: torch.Tensor, edge_count: int) -> torch.Tensor:
    """Row id of every CSR slot (int32), by ``searchsorted`` over
    ``indptr``."""
    slots = torch.arange(edge_count, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, slots, right=True) - 1) \
        .to(torch.int32)


def as_index_rows(indices: torch.Tensor, width: int = 128) -> torch.Tensor:
    """``indices`` padded and cut into ``width``-wide rows: ``(e + 2w -
    1) // w + 1`` of them, so that row ``r0 + 1`` exists for every pick
    window anchored in row ``r0`` (the pair layout reads both)."""
    e = indices.shape[0]
    rows = (e + 2 * width - 1) // width + 1
    pad = torch.zeros(rows * width - e, dtype=indices.dtype,
                      device=indices.device)
    return torch.cat([indices, pad]).reshape(rows, width)


def as_index_rows_overlapping(indices: torch.Tensor,
                              width: int = 128) -> torch.Tensor:
    """The overlapping ``2 * width``-wide view: row ``i`` covers flat
    positions ``[i * width, i * width + 2 * width)``, so any window of
    ``k <= width + 1`` consecutive positions lies in one row (one read
    per seed instead of the pair layout's two, for twice the memory)."""
    base = as_index_rows(indices, width)
    nxt = torch.cat([base[1:], torch.zeros_like(base[:1])])
    return torch.cat([base, nxt], dim=1)


# -- epoch reshuffles -------------------------------------------------------

def _slot_map_dtype(e: int) -> torch.dtype:
    return torch.int32 if e <= _I32_MAX else torch.int64


def _reshuffle_out(permuted, extras, smap, with_slot_map, extra):
    if with_slot_map and extra is not None:
        return permuted, extras, smap
    if with_slot_map:
        return permuted, smap
    if extra is not None:
        return permuted, extras
    return permuted


def permute_csr(indices: torch.Tensor, row_ids: torch.Tensor,
                generator: torch.Generator, with_slot_map: bool = False,
                extra=None):
    """Shuffle every CSR row's neighbour list uniformly, in one stable
    sort of the int64 key ``(row_id << 32) | 32 random bits`` over the
    edge array. The JAX function sorts the two keys at once; the
    packed key gives the same order, ties (equal bits within a row)
    kept in slot order.

    ``with_slot_map`` also returns ``slot_map``, ``slot_map[p]`` the
    original CSR slot now at position ``p``. ``extra`` is a tuple of
    slot-aligned arrays carried through the same order. Returns
    ``permuted``, then ``extras`` and ``slot_map`` where asked for."""
    e = indices.shape[0]
    rand = torch.randint(0, 2**32, (e,), generator=generator,
                         device=indices.device, dtype=torch.int64)
    key = (row_ids.to(torch.int64) << 32) | rand
    _, order = torch.sort(key, stable=True)
    del key, rand
    permuted = indices[order].to(torch.int32)
    extras = tuple(torch.as_tensor(x, device=indices.device)[order]
                   for x in (extra or ()))
    smap = order.to(_slot_map_dtype(e)) if with_slot_map else None
    return _reshuffle_out(permuted, extras, smap, with_slot_map, extra)


def butterfly_shuffle(indices: torch.Tensor, row_ids: torch.Tensor,
                      generator: torch.Generator,
                      with_slot_map: bool = False, max_stride: int = 128,
                      extra=None):
    """A cheap per-epoch re-mix within rows: a masked butterfly network.

    For stride ``s`` in 1, 2, 4, ..., ``max_stride``: the (phase-rolled)
    edge array, viewed as ``[E / 2s, 2, s]``, swaps the two halves of
    each block elementwise where both positions belong to the same CSR
    row and a fresh coin says so. A random phase roll per call moves
    the blocks' alignment, so hub rows also mix across block bounds over
    epochs. An element never leaves its row (a swap needs both sides in
    it), so the CSR structure is kept exactly. One call is not a uniform
    shuffle; feed each epoch's output back in and the order keeps
    mixing.

    The slot map is relative to the input: ``out[p] ==
    indices[slot_map[p]]`` for the array passed in, so edge-id tracking
    composes maps across epochs (:func:`compose_slot_map`). ``extra``
    arrays ride the same swaps. Returns as :func:`permute_csr`. The
    phase is read on the host (one synchronisation per call)."""
    e = indices.shape[0]
    dev = indices.device
    phi = int(torch.randint(0, max(e, 1), (1,), generator=generator,
                            device=dev))
    block = 2 * max_stride
    pad = (-e) % block

    def prep(x, fill):
        x = torch.roll(torch.as_tensor(x, device=dev), phi)
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                        device=dev)])

    rows = prep(row_ids.to(torch.int32), -2)
    arrays = [prep(indices.to(torch.int32), -1)]
    arrays += [prep(x, 0) for x in (extra or ())]
    if with_slot_map:
        arrays.append(prep(torch.arange(e, dtype=_slot_map_dtype(e),
                                        device=dev), -1))
    s = 1
    while s <= max_stride:
        rb = rows.view(-1, 2, s)
        coin = torch.randint(0, 2, rb[:, 0].shape, generator=generator,
                             device=dev, dtype=torch.uint8)
        do = (rb[:, 0] == rb[:, 1]) & coin.bool()
        for i, x in enumerate(arrays):
            xb = x.view(-1, 2, s)
            lo = torch.where(do, xb[:, 1], xb[:, 0])
            hi = torch.where(do, xb[:, 0], xb[:, 1])
            arrays[i] = torch.stack([lo, hi], dim=1).reshape(-1)
        s *= 2
    out = [torch.roll(x[:e], -phi) for x in arrays]
    n_extra = len(extra or ())
    smap = out[-1] if with_slot_map else None
    return _reshuffle_out(out[0], tuple(out[1:1 + n_extra]), smap,
                          with_slot_map, extra)


def reshuffle_csr(indices: torch.Tensor, row_ids: torch.Tensor,
                  generator: torch.Generator, method: str = "sort",
                  with_slot_map: bool = False, extra=None):
    """The per-epoch row-order refresh of rotation and window sampling:
    ``"sort"`` is :func:`permute_csr` (an exact uniform shuffle per
    row), ``"butterfly"`` :func:`butterfly_shuffle` (cheaper, composed
    across epochs)."""
    if method == "sort":
        return permute_csr(indices, row_ids, generator,
                           with_slot_map=with_slot_map, extra=extra)
    if method == "butterfly":
        return butterfly_shuffle(indices, row_ids, generator,
                                 with_slot_map=with_slot_map, extra=extra)
    raise ValueError(f"unknown reshuffle method {method!r}")


def compose_slot_map(prev_map, smap: torch.Tensor, base, bfly: bool):
    """The slot -> edge-id map across reshuffles, in one place:

    - a sort shuffle starts from the original row order every epoch, so
      the map is ``smap`` (``base[smap]`` when the topology has an eid
      map) and ``prev_map`` is ignored;
    - butterfly's ``smap`` is relative to its input (the previous
      epoch's output), so the running map composes: ``prev_map[smap]``,
      seeded from ``base`` or the identity on first use."""
    idx = smap.long()
    if not bfly or prev_map is None:
        return smap if base is None else base.to(smap.device)[idx]
    return prev_map[idx]


# -- the windowed samplers --------------------------------------------------

def _window_layout(indices_rows: torch.Tensor, stride: Optional[int],
                   k: int):
    """Check a windowed-layout (pair or overlapping) request and return
    ``(step, win)``: flat positions per row step and the window's
    length."""
    width = indices_rows.shape[1]
    overlap = stride is not None
    if overlap and width != 2 * stride:
        # a mismatched layout would silently gather the wrong CSR rows
        raise ValueError(
            f"stride={stride} requires an as_index_rows_overlapping "
            f"layout of width 2*stride={2 * stride}, got width {width}")
    step = stride if overlap else width
    k_cap = (step + 1) if overlap else width
    if k > k_cap:
        raise ValueError(
            f"windowed sampling supports k <= {k_cap} for this layout "
            f"(got {k}): the row window only covers that many picks")
    return step, 2 * step


def _gather_window(indices_rows: torch.Tensor, p0: torch.Tensor, step: int,
                   stride: Optional[int], read: torch.Tensor):
    """Each seed's ``2 * step``-wide window anchored at flat position
    ``p0``: one row of the overlapping layout, or rows ``r0`` and
    ``r0 + 1`` of the pair layout, read as one ``take`` whose two rows
    land side by side. Seeds where ``read`` is False read nothing (their
    window is unspecified). Returns ``(window, r0, off)``."""
    r0 = torch.div(p0, step, rounding_mode="floor")
    off = p0 - r0 * step
    ids = torch.where(read, r0, -1)
    if stride is None:
        ids = torch.stack([ids, torch.where(read, r0 + 1, -1)],
                          dim=1).reshape(-1)
    w = take(indices_rows, ids).reshape(p0.shape[0], 2 * step)
    return w, r0, off


def _extract_window_cols(w: torch.Tensor, pos: torch.Tensor, k: int):
    """``nbrs[b, j] = w[b, pos[b, j]]``, 0 outside the window: a gather
    within each row (the JAX package's CPU form; its TPU form, ``k``
    one-hot passes, gives the same values)."""
    width = w.shape[1]
    out = torch.gather(w, 1, pos.long().clamp(0, width - 1))
    return torch.where((pos >= 0) & (pos < width), out, 0).to(torch.int32)


def sample_layer_rotation(indptr: torch.Tensor, indices_rows: torch.Tensor,
                          seeds: torch.Tensor, k: int,
                          generator: torch.Generator,
                          with_slots: bool = False,
                          stride: Optional[int] = None):
    """Rotation sampling: ``min(deg, k)`` consecutive entries of the
    (reshuffled) neighbour row at a uniform random offset. With the rows
    reshuffled every epoch each pick is marginally uniform and the picks
    are distinct; within an epoch the subsets are runs of that epoch's
    order (``sample_layer`` draws i.i.d. subsets).

    ``indices_rows`` is ``as_index_rows`` (pair: two row reads build the
    window, ``k <= width``) or ``as_index_rows_overlapping`` with
    ``stride=width`` (one row read, ``k <= stride + 1``). Returns
    ``(nbrs [bs, k] -1 fill, counts [bs])``; with ``with_slots`` also
    each pick's flat position in the reshuffled edge array (-1 fill)."""
    step, _ = _window_layout(indices_rows, stride, k)
    start, deg = _segment_heads(indptr, seeds)
    counts = deg.clamp(max=k).to(torch.int32)
    o = _uniform_below(generator, (deg - k).clamp(min=0) + 1)
    p0 = start + o                      # the window anchored at the pick
    w, _, off = _gather_window(indices_rows, p0, step, stride, deg > 0)
    run = torch.arange(k, device=seeds.device)[None, :]
    nbrs = _extract_window_cols(w, off[:, None] + run, k)
    mask = _pick_mask(counts, k)
    nbrs = torch.where(mask, nbrs, -1)
    if with_slots:
        return nbrs, counts, torch.where(mask, p0[:, None] + run, -1)
    return nbrs, counts


def sample_layer_window(indptr: torch.Tensor, indices_rows: torch.Tensor,
                        seeds: torch.Tensor, k: int,
                        generator: torch.Generator,
                        with_slots: bool = False,
                        stride: Optional[int] = None):
    """Window sampling: an i.i.d. ``min(deg, k)``-subset drawn uniformly
    without replacement from a window of at least ``step + 1`` entries
    of the (reshuffled) neighbour row.

    A row whose whole segment fits its start-anchored window draws from
    all of it, exactly the reference's draw under any row order. A hub
    row anchors its window at a uniform random offset (rotation's
    guarantee over the per-epoch reshuffle) and draws an independent
    subset inside it. Two draws from ``generator``, in order: the
    anchors, then the positions (``_fisher_yates_rows``). The same row
    reads as rotation. Returns as :func:`sample_layer_rotation`."""
    step, win = _window_layout(indices_rows, stride, k)
    start, deg = _segment_heads(indptr, seeds)
    counts = deg.clamp(max=k).to(torch.int32)
    o = _uniform_below(generator, (deg - (step + 1)).clamp(min=0) + 1)
    o = torch.where(deg <= win - start % step, 0, o)
    p0 = start + o
    w, r0, off = _gather_window(indices_rows, p0, step, stride, deg > 0)
    # the window covers positions [o, o + cap) of the segment, cap =
    # min(deg - o, win - off) >= min(deg, step + 1)
    cap = torch.minimum(deg - o, win - off)
    picks = off[:, None] + _fisher_yates_rows(generator, cap, k)
    nbrs = _extract_window_cols(w, picks, k)
    mask = _pick_mask(counts, k)
    nbrs = torch.where(mask, nbrs, -1)
    if with_slots:
        slots = (r0 * step)[:, None] + picks
        return nbrs, counts, torch.where(mask, slots, -1)
    return nbrs, counts


# -- the wide-exact sampler -------------------------------------------------

class ExactBucketMeta(NamedTuple):
    """The degree-bucket split of the wide-exact sampler, computed once
    per (graph, layout step) and cached on ``CSRTopo``.

    A row is a hub when its segment does not fit its start-anchored
    window (``deg > 2 * step - start % step``), the classification
    ``sample_layer_exact_wide`` applies per seed.

    node_frac: the fraction of nodes that are hubs (a uniform batch's
               hub rate);
    edge_frac: the fraction of edges owned by hubs (a hop frontier's,
               whose seeds arrive roughly in proportion to degree);
    frac:      the larger, from which ``suggest_hub_cap`` sizes the
               static budget of scattered reads.
    """

    node_frac: float
    edge_frac: float
    frac: float


def exact_bucket_meta(indptr, step: int = 128) -> ExactBucketMeta:
    """Classify every row against the window ``2 * step`` and reduce to
    the bucket split's fractions (host floats). Takes a torch tensor on
    any device or a numpy array; reads two sums back to the host."""
    ip = torch.as_tensor(indptr).long()
    win = 2 * step
    start = ip[:-1]
    deg = ip[1:] - start
    hub = deg > (win - start % step)
    n = max(int(deg.shape[0]), 1)
    e = max(int(deg.sum()), 1)
    node_frac = float(hub.sum()) / n
    edge_frac = float((deg * hub).sum()) / e
    return ExactBucketMeta(node_frac=node_frac, edge_frac=edge_frac,
                           frac=max(node_frac, edge_frac))


def suggest_hub_cap(num_seeds: int, hub_frac: Optional[float]):
    """The static budget of scattered reads for a ``num_seeds``-wide
    batch from the graph's hub fraction (``ExactBucketMeta.frac``): 3x
    the expected hub count plus 64, at most ``num_seeds``. ``None`` (no
    metadata) keeps the sampler's default of ``bs // 2``."""
    if hub_frac is None:
        return None
    return int(min(num_seeds,
                   math.ceil(num_seeds * min(1.0, 3.0 * hub_frac)) + 64))


def sample_layer_exact_wide(indptr: torch.Tensor, indices: torch.Tensor,
                            indices_rows: torch.Tensor, seeds: torch.Tensor,
                            k: int, generator: torch.Generator,
                            stride: Optional[int] = None,
                            hub_cap: Optional[int] = None,
                            with_slots: bool = False):
    """Exact i.i.d. sampling read through a rows view: the draw of
    :func:`sample_layer`, bit for bit for the same generator state (the
    positions come from the one ``_fisher_yates_rows`` call it makes
    too), with one (overlap layout) or two (pair) row reads for every
    seed whose segment fits its start-anchored window instead of ``k``
    scattered reads. Only hub rows read scattered, up to ``hub_cap`` of
    them (default ``bs // 2``; ``suggest_hub_cap`` sizes it from the
    graph's ``ExactBucketMeta``).

    The JAX function falls back to a full scattered read with a
    ``lax.cond`` when a batch has more hubs than the budget. Here both
    reads are issued and predicated on the card, so the host decides
    nothing: the reads of the branch not taken get id -1, which reads
    nothing from a pinned host topology and slot 0 from a device one.

    ``indices_rows`` is a layout view of the same, un-shuffled
    ``indices`` (no reshuffle is needed: Fisher–Yates positions are
    uniform under any fixed order). Returns ``(nbrs [bs, k] -1 fill,
    counts [bs])``; with ``with_slots`` also each pick's CSR slot."""
    step, win = _window_layout(indices_rows, stride, 1)  # k-cap-free
    start, deg = _segment_heads(indptr, seeds)
    counts = deg.clamp(max=k).to(torch.int32)
    bs = seeds.shape[0]
    e = indices.shape[0]
    dev = seeds.device
    picks = _fisher_yates_rows(generator, deg, k)
    mask = _pick_mask(counts, k)
    slots = start[:, None] + picks

    # wide path: every row whose segment fits its start-anchored window
    low = deg <= win - start % step
    w, _, off = _gather_window(indices_rows, start, step, stride,
                               low & (deg > 0))
    nbrs = _extract_window_cols(
        w, torch.where(low[:, None], off[:, None] + picks, 0), k)

    # hub path: scattered reads for at most hub_cap rows, stream-compacted
    hub_cap = min(max(1, bs // 2) if hub_cap is None else hub_cap, bs)
    hub = ~low & (deg > 0)
    n_hub = hub.sum()
    overflow = n_hub > hub_cap
    hrank = torch.cumsum(hub, 0) - 1
    tgt = torch.where(hub & (hrank < hub_cap), hrank, hub_cap)
    iota = torch.arange(bs, dtype=torch.int64, device=dev)
    hpos = torch.zeros(hub_cap + 1, dtype=torch.int64, device=dev) \
        .index_copy_(0, tgt, iota)[:hub_cap]
    h_valid = (torch.arange(hub_cap, device=dev) < n_hub) & ~overflow
    h_slot = slots[hpos].clamp(0, max(e - 1, 0))
    h_nbrs = take(indices, torch.where(h_valid[:, None] & mask[hpos],
                                       h_slot, -1)).to(torch.int32)
    buf = torch.cat([nbrs, nbrs.new_zeros((1, k))])
    buf.index_copy_(0, torch.where(h_valid, hpos, bs), h_nbrs)
    nbrs = buf[:bs]

    # the overflow: every pick scattered, read only when taken
    full = take(indices, torch.where(overflow & mask,
                                     slots.clamp(0, max(e - 1, 0)), -1))
    nbrs = torch.where(overflow, full.to(torch.int32), nbrs)
    nbrs = torch.where(mask, nbrs, -1)
    if with_slots:
        return nbrs, counts, torch.where(mask, slots, -1)
    return nbrs, counts


# -- sampled-probability propagation ----------------------------------------

def sample_prob_step(indptr: torch.Tensor, indices: torch.Tensor,
                     last_prob: torch.Tensor, k: int,
                     row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One hop of sampled-probability propagation (the reference's
    ``cal_next``): for each node ``v`` with neighbours ``u``,

        cur[v] = 1 - (1 - last[v]) * prod_u (1 - last[u] * min(1, k/deg(u)))

    and ``cur[v] = 0`` where ``deg(v) == 0``. The product is a
    ``scatter_reduce`` (``"prod"``), whose order differs from the JAX
    package's ``segment_prod``: equal within float rounding."""
    n = indptr.shape[0] - 1
    deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
    frac = torch.where(deg > 0, torch.clamp(k / deg.clamp(min=1.0), max=1.0),
                       0.0)
    skip = 1.0 - last_prob * frac
    if row_ids is None:
        row_ids = edge_rows(indptr, indices.shape[0])
    acc = torch.ones(n, dtype=torch.float32, device=indptr.device) \
        .scatter_reduce(0, row_ids.long(), skip[indices.long()], "prod")
    cur = 1.0 - (1.0 - last_prob) * acc
    return torch.where(deg > 0, cur, 0.0)


def sample_prob(indptr: torch.Tensor, indices: torch.Tensor,
                train_idx: torch.Tensor, sizes,
                total_node_count: int) -> torch.Tensor:
    """The k-hop access probability from the train seeds (the
    reference's ``sample_prob``), which feeds cache ordering and
    partitioning."""
    prob = torch.zeros(total_node_count, dtype=torch.float32,
                       device=indptr.device)
    prob[torch.as_tensor(train_idx, device=indptr.device).long()] = 1.0
    rows = edge_rows(indptr, indices.shape[0])
    for k in sizes:
        prob = sample_prob_step(indptr, indices, prob, k, row_ids=rows)
    return prob
