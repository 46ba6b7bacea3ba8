"""Weighted neighbour sampling, the GAT attention-weighted path
(counterpart of ``quiver_tpu/ops/weighted.py``).

Per seed, ``k`` independent draws with replacement, each proportional to
its edge's weight (the reference's ``weight_sample``). Each seed's
weights are gathered into a fixed-width pool, negatives clamped to 0,
and its CDF built row-locally in fp32 (a global cumsum over 1e8 edges
would run out of fp32 resolution). A draw ``u * total`` picks the
number of CDF entries ``<= u * total``.

Two draws:

- ``sample_layer_weighted``: the pool is the seed's first ``row_cap``
  slots in CSR order (a row of higher degree samples among its first
  ``row_cap`` neighbours, the documented truncation of the JAX package).
- ``sample_layer_weighted_window``: the pool is the seed's window in the
  rows views of an epoch's reshuffled ``indices`` and its co-shuffled
  weights (``reshuffle_csr(..., extra=(weights,))``): weight-exact for
  rows that fit the window, renormalised within the window for hubs.

Weights and neighbour ids are read through ``ops/sample.py: take`` and
``take_segments`` (the pool's weights, a span a seed), so a topology and
weights pinned in host memory (the sampler's HOST mode) are read by the
card's gathers, and only the slots a draw needs are read.
Both draws come from an explicit ``torch.Generator``: ``[bs, k]`` fp32
uniforms, then the deterministic stage (``_pool_draw``,
``_window_draw``), which takes the uniforms as an argument.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sample import (_extract_window_cols, _gather_window, _pick_mask,
                     _segment_heads, _window_layout, as_draws, take,
                     take_segments)


def _draw_uniforms(generator, bs: int, k: int, device) -> torch.Tensor:
    """The ``[bs, k]`` fp32 uniforms in ``[0, 1)`` of one weighted hop."""
    return as_draws(generator).uniforms(bs, k, device)


def _cdf_positions(w_row: torch.Tensor, u: torch.Tensor):
    """Row-local fp32 CDF of the clamped weights ``w_row`` ``[bs, W]``
    and, per uniform ``u`` ``[bs, k]``, the number of CDF entries ``<= u
    * total``. Returns ``(pos [bs, k] int64, total [bs])``.

    ``searchsorted(..., right=True)`` counts the entries ``<= target`` on
    a non-decreasing CDF, which the clamp of negatives makes it; that is
    the JAX package's ``sum(u >= cdf)`` without its ``[bs, k, W]``
    compare tensor (1.8 GB at hop 2 of [15, 10, 5]). A NaN weight breaks
    the order and with it this equality."""
    cdf = torch.cumsum(w_row, dim=1)
    total = cdf[:, -1]
    target = u * total[:, None]
    return torch.searchsorted(cdf, target.contiguous(), right=True), total


def _live(counts, total, k):
    """The picks that count: those below ``counts`` of a row with mass."""
    return _pick_mask(counts, k) & (total[:, None] > 0)


def _masked_out(nbrs, counts, total, live, slots, with_slots):
    """``-1`` at every pick not ``live``; a zero-mass row counts 0."""
    nbrs = torch.where(live, nbrs, -1)
    counts = torch.where(total > 0, counts, 0)
    if with_slots:
        return nbrs, counts, torch.where(live, slots, -1)
    return nbrs, counts


def _pool_draw(indptr, indices, weights, seeds, k, u, row_cap,
               with_slots):
    """``sample_layer_weighted`` on given uniforms ``u`` ``[bs, k]``."""
    start, deg = _segment_heads(indptr, seeds)
    counts = deg.clamp(max=k).to(torch.int32)
    pool = deg.clamp(max=row_cap)
    offs = torch.arange(row_cap, device=seeds.device)[None, :]
    in_row = offs < pool[:, None]
    # only the live slots are read: a pinned weight array gives HOST mode
    # one read of each seed's span of live weights, and no id array
    w = take_segments(weights, start, pool, row_cap)
    # in place: w is the read's own [bs, row_cap] tensor
    w_row = w.to(torch.float32).clamp_(min=0.0).masked_fill_(~in_row, 0.0)
    del w, in_row
    pos, total = _cdf_positions(w_row, u)
    del w_row
    # u can round up to total in fp32: clamp to the pool's last entry
    pos = torch.minimum(pos, (pool - 1).clamp(min=0)[:, None])
    slots = start[:, None] + pos
    live = _live(counts, total, k)
    nbrs = take(indices, torch.where(live, slots, -1)).to(torch.int32)
    return _masked_out(nbrs, counts, total, live, slots, with_slots)


def sample_layer_weighted(indptr: torch.Tensor, indices: torch.Tensor,
                          weights: torch.Tensor, seeds: torch.Tensor, k: int,
                          generator: torch.Generator, row_cap: int = 2048,
                          with_slots: bool = False):
    """Per seed, ``k`` draws proportional to edge weight, with
    replacement. ``weights`` is CSR-slot-aligned
    (:func:`csr_weights_from_eid` reorders COO weights). Returns
    ``(nbrs [bs, k] int32 -1 fill, counts [bs] int32)``, ``counts ==
    min(deg, k)``, and a row whose clamped weights sum to 0 fully masked;
    ``with_slots`` adds each pick's CSR slot (``[bs, k]``, -1 fill).

    ``generator`` lives on the seeds' device; the topology and the
    weights lie there or in pinned host memory (``sample.take``)."""
    u = _draw_uniforms(generator, seeds.shape[0], k, seeds.device)
    if indices.shape[0] == 0:            # no edge to read: all masked
        nbrs = torch.full((seeds.shape[0], k), -1, dtype=torch.int32,
                          device=seeds.device)
        counts = torch.zeros_like(seeds, dtype=torch.int32)
        return (nbrs, counts, nbrs.long()) if with_slots else (nbrs, counts)
    return _pool_draw(indptr, indices, weights, seeds, k, u, int(row_cap),
                      with_slots)


def _window_draw(indptr, indices_rows, weight_rows, seeds, k, u, stride,
                 with_slots):
    """``sample_layer_weighted_window`` on given uniforms ``u``."""
    step, win = _window_layout(indices_rows, stride, k)
    if tuple(weight_rows.shape) != tuple(indices_rows.shape):
        raise ValueError(
            f"weight_rows {tuple(weight_rows.shape)} must mirror "
            f"indices_rows {tuple(indices_rows.shape)} (same layout, same "
            "shuffle)")
    start, deg = _segment_heads(indptr, seeds)
    counts = deg.clamp(max=k).to(torch.int32)
    read = deg > 0
    w_ids, r0, off = _gather_window(indices_rows, start, step, stride, read)
    w_wts, _, _ = _gather_window(weight_rows, start, step, stride, read)
    cap = torch.minimum(deg, win - off)
    wiota = torch.arange(win, device=seeds.device)[None, :]
    in_seg = (wiota >= off[:, None]) & (wiota < (off + cap)[:, None])
    w_row = torch.where(in_seg, w_wts.to(torch.float32).clamp(min=0.0), 0.0)
    del w_wts, in_seg
    pos, total = _cdf_positions(w_row, u)
    # u can round up to total: clamp to the last position in the segment
    # (not the window's edge, which holds another row or padding)
    pos = torch.minimum(pos, (off + cap.clamp(min=1) - 1)[:, None])
    nbrs = _extract_window_cols(w_ids, pos, k)
    return _masked_out(nbrs, counts, total, _live(counts, total, k),
                       (r0 * step)[:, None] + pos, with_slots)


def sample_layer_weighted_window(indptr: torch.Tensor,
                                 indices_rows: torch.Tensor,
                                 weight_rows: torch.Tensor,
                                 seeds: torch.Tensor, k: int,
                                 generator: torch.Generator,
                                 stride: Optional[int] = None,
                                 with_slots: bool = False):
    """Windowed weighted sampling: ``k`` draws proportional to edge
    weight, with replacement, from the window anchored at the seed's
    segment start in the reshuffled row layout (``indices_rows`` and
    ``weight_rows``, two views of one shuffle:
    ``reshuffle_csr(..., extra=(weights,))`` then ``as_index_rows`` or
    ``as_index_rows_overlapping`` of both, ``stride`` as for
    ``sample_layer_rotation``). One (overlap) or two (pair) row reads
    per seed from each layout, in place of the pool's ``row_cap``
    scattered reads.

    Weight-exact for rows that fit the window; a hub draws within the
    epoch's window, renormalised there, which under-samples its heavy
    edges even in expectation over reshuffles (the JAX docstring works
    an example). Use the pool draw where hub weights matter.

    Returns as :func:`sample_layer_weighted`; ``with_slots`` gives each
    pick's flat position in the reshuffled array (map it through the
    shuffle's slot map for the CSR slot)."""
    u = _draw_uniforms(generator, seeds.shape[0], k, seeds.device)
    return _window_draw(indptr, indices_rows, weight_rows, seeds, k, u,
                        stride, with_slots)


def csr_weights_from_eid(eid, coo_weights) -> torch.Tensor:
    """COO-ordered edge weights in CSR slot order, through the topology's
    edge-id map (``CSRTopo.eid``), on ``eid``'s device."""
    eid = torch.as_tensor(eid)
    return torch.as_tensor(coo_weights).to(eid.device)[eid.long()]
