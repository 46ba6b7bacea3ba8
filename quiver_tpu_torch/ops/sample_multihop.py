"""Multi-hop sampling (counterpart of
``quiver_tpu/ops/sample_multihop.py``).

Every hop runs one sampler of ``ops/sample.py`` (exact, wide exact,
rotation or window) or of ``ops/weighted.py`` (the weighted pool draw,
or the windowed weighted draw) and compacts its picks into the next
hop's frontier. All hops draw, in order, from the one
``torch.Generator`` the call is given, where the JAX function folds its
key per hop. The topology and the weights lie on the seeds' device or
in pinned host memory (``sample.take``). A ``metrics.Collector``
records the final frontier's valid slots and its capacity.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import metrics, tracing
from .. import profiling  # noqa: F401  (the torch side of the spans)
from .sample import (KeyedDraws, LayerSample, StreamDraws, _draw_offsets,
                     _draw_positions, as_index_rows, as_index_rows_overlapping,
                     compact_ids, compact_layer, edge_row_ids, permute_csr,
                     sample_layer, sample_layer_exact_wide,
                     sample_layer_rotation, sample_layer_window,
                     suggest_hub_cap, take)
from .weighted import sample_layer_weighted, sample_layer_weighted_window

_METHODS = ("exact", "rotation", "window")


class KeyedWalk:
    """The hops' draws keyed by node id and hop, passed to
    :func:`sample_multihop` in place of its generator: hop ``i`` draws
    from ``KeyedDraws(hop_seeds[i], frontier)``, so each seed's sampled
    tree is the same in any batch that holds it (the 2-D train step's
    ``data`` ranks each walk their slice of the batch). Unweighted hops
    only."""

    def __init__(self, hop_seeds: Sequence[int]):
        self.hop_seeds = [int(s) for s in hop_seeds]

    def hop(self, i: int, ids: torch.Tensor) -> KeyedDraws:
        if i >= len(self.hop_seeds):
            raise ValueError(f"a KeyedWalk needs one seed per hop: "
                             f"{len(self.hop_seeds)} seeds")
        return KeyedDraws(self.hop_seeds[i], ids)

    def stream(self):
        raise ValueError("a KeyedWalk cannot draw the per-call shuffle: "
                         "pass indices_rows")


def _check_knobs(method, edge_weight, indices_rows, weight_rows):
    """The JAX function's coupled-parameter ``ValueError``s."""
    if method not in _METHODS:
        raise ValueError(f"unknown sampling method {method!r}")
    windowed = method in ("rotation", "window")
    if weight_rows is not None and (edge_weight is None or not windowed):
        raise ValueError(
            "weight_rows is only consumed by windowed WEIGHTED sampling "
            "— pass edge_weight (the trigger) and a rotation/window "
            "method with it, or drop it")
    if (edge_weight is not None and windowed and indices_rows is not None
            and weight_rows is None):
        raise ValueError(
            "weighted windowed sampling needs weight_rows co-shuffled "
            "with indices_rows (reshuffle_csr(..., extra=(edge_weight,)) "
            "then as_index_rows* both); drop indices_rows for the exact "
            "pool draw")
    if edge_weight is not None and not windowed and indices_rows is not None:
        raise ValueError(
            "indices_rows is not consumed by exact WEIGHTED sampling "
            "(the pool draw is scattered) — drop indices_rows, or use a "
            "rotation/window method with weight_rows for the windowed "
            "weighted draw")
    if weight_rows is not None and indices_rows is None:
        raise ValueError(
            "windowed weighted sampling needs indices_rows from the same "
            "shuffle as weight_rows (reshuffle_csr with "
            "extra=(edge_weight,), then as_index_rows* both)")


def _skip_hop_draws(generator, method, bs, sizes, device):
    """Advance ``generator`` exactly as the hops of ``method`` at ``bs``
    seeds draw from it (the draws depend on the static frontier widths
    only)."""
    for k in sizes:
        if method in ("rotation", "window"):
            _draw_offsets(generator, bs, device)
        if method != "rotation":
            _draw_positions(generator, bs, k, device)
        bs *= 1 + k


def _fallback_rows(indptr, indices, seeds, sizes, generator, method,
                   indices_stride, eid):
    """Rotation or window without ``indices_rows``: one ``permute_csr``
    of the topology on the seeds' device, so the draw is still
    marginally uniform. Its draws come from ``generator`` after the
    hops' draws (the JAX function keys it with ``fold_in(key,
    len(sizes))``, past the hops' ``0..len-1``): the hops' draws are
    skipped, the shuffle drawn, and the state put back for the hops.
    Returns ``(rows, eid, state after the shuffle)``."""
    dev = seeds.device
    before = generator.get_state()
    _skip_hop_draws(generator, method, seeds.shape[0], sizes, dev)
    ix = indices.to(dev)
    rids = edge_row_ids(indptr.to(dev), ix.shape[0])
    as_rows = (as_index_rows if indices_stride is None else
               (lambda x: as_index_rows_overlapping(x, width=indices_stride)))
    if eid is not None:
        # rotation slots index the permuted array; compose the caller's
        # eid map with the permutation's slot map
        permuted, smap = permute_csr(ix, rids, generator, with_slot_map=True)
        eid = smap if eid is True else \
            torch.as_tensor(eid).to(dev)[smap.long()]
    else:
        permuted = permute_csr(ix, rids, generator)
    after = generator.get_state()
    generator.set_state(before)
    return as_rows(permuted), eid, after


def sample_multihop(indptr: torch.Tensor, indices: torch.Tensor,
                    seeds: torch.Tensor, sizes: Sequence[int],
                    generator: torch.Generator, edge_weight=None,
                    method: str = "exact", indices_rows=None, eid=None,
                    indices_stride=None, seeds_dense: bool = False,
                    weight_rows=None, hub_frac=None, collector=None,
                    ) -> Tuple[torch.Tensor, List[LayerSample]]:
    """Expand ``seeds`` through ``sizes`` hops. Returns the final
    frontier ``n_id`` (static capacity, -1 fill) and the per-hop
    ``LayerSample``s in sampling order (innermost target hop first).

    ``method``: ``"exact"`` (i.i.d. Fisher–Yates subsets; with
    ``indices_rows``, a layout view of the same un-shuffled
    ``indices``, the wide-exact read, the same draw), ``"rotation"``
    or ``"window"`` (``indices_rows`` a view of an ``indices`` that is
    reshuffled per epoch; without it, one ``permute_csr`` is applied
    here). ``indices_stride`` is the build width when ``indices_rows``
    came from ``as_index_rows_overlapping``. ``hub_frac``
    (``ExactBucketMeta.frac``) sizes each wide-exact hop's budget of
    scattered reads.

    ``edge_weight`` (CSR-slot-aligned) switches every hop to weighted
    sampling (``ops/weighted.py``): the ``row_cap`` pool draw, or, with
    a windowed ``method`` and ``weight_rows`` (the weights' rows view
    from the same shuffle as ``indices_rows``:
    ``reshuffle_csr(..., extra=(edge_weight,))`` then ``as_index_rows*``
    of both), the windowed weighted draw. A windowed method with weights
    and neither rows view takes the pool draw.

    ``eid``: ``True`` stamps each sampled edge with its CSR slot (the
    position in the reshuffled array under rotation and window); a
    tensor stamps ``eid[slot]`` (``CSRTopo.eid``, or the co-permuted map
    of a reshuffle). The ids land in ``LayerSample.e_id`` (-1 fill).

    ``generator`` is a ``torch.Generator`` on the seeds' device, or a
    :class:`KeyedWalk` (draws keyed by node id and hop); the
    topology arrays lie there or in pinned host memory. ``seeds_dense``
    promises the hop-0 seeds are valid-first (-1 fill only at the tail);
    later hops always are. ``collector`` (a ``metrics.Collector``)
    records ``FRONTIER_VALID`` (the final frontier's valid slots, on
    the card) and ``FRONTIER_CAP`` (its static capacity)."""
    _check_knobs(method, edge_weight, indices_rows, weight_rows)
    windowed = method in ("rotation", "window")
    walk = generator if hasattr(generator, "hop") \
        else StreamDraws(generator)
    after = None
    if windowed and indices_rows is None and edge_weight is None:
        generator = walk.stream()
        indices_rows, eid, after = _fallback_rows(
            indptr, indices, seeds, sizes, generator, method,
            indices_stride, eid)
    cur = seeds.to(torch.int32)
    layers: List[LayerSample] = []
    drawn = "weighted" if edge_weight is not None else method
    for i, k in enumerate(sizes):
        with tracing.span("sample.draw", args={"hop": i, "method": drawn}):
            out = _draw(indptr, indices, edge_weight, method, indices_rows,
                        weight_rows, indices_stride, hub_frac, cur, int(k),
                        walk.hop(i, cur), eid is not None)
        with tracing.span("sample.compact", args={"hop": i}):
            layer = compact_layer(cur, out[0],
                                  seeds_dense=(i > 0) or seeds_dense)
        if eid is not None:
            flat = out[2].reshape(-1)
            ids = flat if eid is True else take(eid, flat)
            layer = layer._replace(e_id=torch.where(flat >= 0, ids, -1))
        layers.append(layer)
        cur = layer.n_id
    if after is not None:
        generator.set_state(after)
    if collector is not None:
        collector.add(metrics.FRONTIER_VALID,
                      (cur >= 0).sum(dtype=torch.int32))
        collector.add(metrics.FRONTIER_CAP, int(cur.shape[0]))
    return cur, layers


def _draw(indptr, indices, edge_weight, method, indices_rows, weight_rows,
          indices_stride, hub_frac, cur, k, gen, track):
    """One hop's draw from ``cur`` by the sampler the knobs pick."""
    if weight_rows is not None:
        return sample_layer_weighted_window(
            indptr, indices_rows, weight_rows, cur, k, gen,
            stride=indices_stride, with_slots=track)
    if edge_weight is not None:
        return sample_layer_weighted(indptr, indices, edge_weight, cur, k,
                                     gen, with_slots=track)
    if method == "rotation":
        return sample_layer_rotation(indptr, indices_rows, cur, k, gen,
                                     with_slots=track, stride=indices_stride)
    if method == "window":
        return sample_layer_window(indptr, indices_rows, cur, k, gen,
                                   with_slots=track, stride=indices_stride)
    if indices_rows is not None:
        return sample_layer_exact_wide(
            indptr, indices, indices_rows, cur, k, gen,
            stride=indices_stride, with_slots=track,
            hub_cap=suggest_hub_cap(int(cur.shape[0]), hub_frac))
    return sample_layer(indptr, indices, cur, k, gen, with_slots=track)


def sample_multihop_dedup(indptr: torch.Tensor, indices: torch.Tensor,
                          batch: torch.Tensor, sizes: Sequence[int],
                          generator: torch.Generator, **kwargs):
    """:func:`sample_multihop` for a batch that may hold duplicate ids
    (an unsupervised ``[seeds | positives | negatives]`` triple). The
    batch is deduplicated first (the compaction needs distinct seeds).
    Returns ``(n_id, layers, batch_locals)``, ``batch_locals[i]`` the
    row of ``batch[i]`` in the model's output."""
    ubatch, _, blocals = compact_ids(batch.to(torch.int32))
    kwargs.setdefault("seeds_dense", True)   # compact_ids output is dense
    n_id, layers = sample_multihop(indptr, indices, ubatch, sizes,
                                   generator, **kwargs)
    return n_id, layers, blocals
