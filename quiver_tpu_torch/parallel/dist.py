"""Multi-host training over a partitioned feature store (counterpart of
``quiver_tpu/parallel/dist.py``).

The reference's multi-node benchmark runs one process per rank, each
sampling its own seeds and fetching the frontier's rows through
``DistFeature``'s exchange (benchmarks/ogbn-papers100M/
train_quiver_multi_node.py:270-411). The JAX package fuses that into one
``shard_map`` program; here each rank runs the same three stages itself:

  1. samples its own seed block's k-hop frontier (topology on every
     rank), from a generator seeded with its own ``hop_seeds``;
  2. fetches the frontier's rows from their owners by the
     ``all_to_all`` exchange (``comm.dist_lookup_local``: the table
     stays partitioned);
  3. runs forward and backward, and averages the gradients and the loss
     over the group with one ``all_reduce`` before the update.

The loss is the single-card step's with the feature gather swapped for
the exchange, so the dist step's loss equals the data-parallel step's
(``build_e2e_train_step``) over the same seeds and streams.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import metrics
from ..comm import default_exchange_cap, dist_lookup_local
from ..pyg.sage_sampler import layer_shapes
from .mesh import axis_size
from .train import (TrainState, _check_method, _check_rows, _fused_loss,
                    _mean_outputs, draw_step_seeds)


def fold_in(seed: int, rank: int) -> int:
    """A seed for ``rank`` derived from a step's ``seed``, distinct per
    rank (the counterpart of JAX's ``fold_in(key, axis_index)``)."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(rank)])
    return int(state.generate_state(1, np.uint64)[0] >> 1)


def rank_step_seeds(seed: int, rank: int, hops: int):
    """This rank's ``(hop_seeds, dropout_seed)`` for a step whose ranks
    share ``seed``: drawn from a host generator seeded with
    ``fold_in(seed, rank)``, so ranks sample different streams and a
    replay of the same ``(seed, rank)`` draws the same ones."""
    gen = torch.Generator().manual_seed(fold_in(seed, rank))
    return draw_step_seeds(gen, hops)


def build_dist_train_step(model, optimizer, sizes: Sequence[int],
                          per_host_batch: int, group, rows_per_host: int,
                          method: str = "exact",
                          indices_stride: Optional[int] = None,
                          with_replicate: bool = False,
                          hub_frac: Optional[float] = None,
                          exchange_cap=None,
                          collect_metrics: bool = False,
                          merge_counters: bool = False):
    """One rank's part of the multi-host step:
    ``step(state, feat, g2h, g2l, indptr, indices, seeds, labels,
    hop_seeds, dropout_seed, indices_rows=None, rep_args=())`` ->
    ``(state, loss)``; every rank of ``group`` calls it together.

    ``feat`` is this rank's ``[rows_per_host, dim]`` shard
    (``DistFeature.from_partition``'s ``shard``; an int8 shard lies in
    packed rows, ``quant.pack``, ships them and decodes after the
    exchange), ``g2h``/``g2l`` the
    owner and local-row maps (``DistFeature``'s device copies), the
    topology whole on every rank, ``seeds``/``labels`` this rank's
    ``[per_host_batch]`` block (distinct valid seeds first, -1 tail
    fill) and ``hop_seeds``/``dropout_seed`` this rank's streams
    (:func:`rank_step_seeds`). Sampling is the split route of
    ``build_train_step`` with ``method`` (exact; rotation and window
    need ``indices_rows``, the per-epoch reshuffled rows view;
    ``indices_stride=128`` for the overlapping one), all hops from one
    generator seeded with ``hop_seeds[0]``.

    ``with_replicate=True`` takes ``rep_args`` = ``(is_rep, rep_rank,
    bases)`` (``DistFeature._rep_args``), so replicated nodes resolve
    against this rank's replica tail. ``exchange_cap`` (``True | int |
    None``) compacts the exchange (``comm.dist_lookup_local``; True
    sizes it from the frontier's capacity, prefer
    ``PartitionInfo.plan_exchange_cap(...).cap``); the loss is the same
    either way. The update averages gradients and loss over the group
    (``build_e2e_train_step``'s). ``collect_metrics=True`` adds this
    rank's ``[1, N]`` counter block (frontier fill, the exchange's
    counters), or with ``merge_counters`` the group's ``[N]`` vector."""
    sizes = [int(k) for k in sizes]
    _check_method(method)
    h_count = axis_size(group)
    if merge_counters and not collect_metrics:
        raise ValueError("merge_counters=True requires "
                         "collect_metrics=True")
    if exchange_cap is True:
        frontier = layer_shapes(per_host_batch, sizes)[-1].n_id_cap
        exchange_cap = default_exchange_cap(frontier, h_count)
    elif exchange_cap is not None:
        exchange_cap = int(exchange_cap)

    def step(state: TrainState, feat, g2h, g2l, indptr, indices, seeds,
             labels, hop_seeds, dropout_seed, indices_rows=None,
             rep_args=()):
        _check_rows(method, indices_rows, "dist")
        if with_replicate and len(rep_args) != 3:
            raise TypeError(
                "with_replicate dist step requires rep_args = "
                "(is_rep, rep_rank, bases): pass DistFeature._rep_args")
        if rep_args and not with_replicate:
            raise TypeError("rep_args given but with_replicate=False")

        def gather(feat_, n_id, _forder, collector=None):
            return dist_lookup_local(n_id, g2h, g2l, feat_, group, h_count,
                                     rows_per_host, rep=tuple(rep_args)
                                     or None, exchange_cap=exchange_cap,
                                     collector=collector)

        model.train()
        col = metrics.Collector(seeds.device) if collect_metrics else None
        loss = _fused_loss(model, sizes, per_host_batch, feat, None, indptr,
                           indices, seeds, labels, hop_seeds, dropout_seed,
                           gather=gather, collector=col, method=method,
                           indices_rows=indices_rows,
                           indices_stride=indices_stride, hub_frac=hub_frac)
        return _mean_outputs(state, model, optimizer, loss, col, group,
                             merge_counters)

    return step
