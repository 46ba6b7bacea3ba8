"""Static-budget frontier deduplication (counterpart of
``quiver_tpu/ops/dedup.py``).

Multi-hop frontiers repeat hub nodes many times, so a gather that reads
one row per frontier slot moves the duplicate factor times more bytes
than one that reads one row per unique node. ``unique_within_budget``
ranks the distinct ids into a fixed-size table plus an inverse map, with
tensor ops of static shape (sort, first-flags, ``cumsum`` rank, a
scatter with a drop slot, ``searchsorted``), and never reads a count
back to the host.

Where the JAX package branches with ``lax.cond`` on the unique count,
the port predicates the ids of each branch's gather: a slot the branch
would not read gets -1, which ``gather_rows`` skips (it reads nothing
for it and leaves its output row as it is). Both branches run on the
card; only the taken one reads the table.

``collector`` (a ``metrics.Collector``) records the dedup statistics the
JAX functions record: one call, the counted ids, the true distinct count
and whether it overflowed the budget, from values already computed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics
from . import quant
from .kernels._build import gated
from .kernels.gather import gather_rows

I32_MAX = 2**31 - 1


def unique_within_budget(ids: torch.Tensor, budget: int, valid=None,
                         collector=None):
    """Compact the distinct values of ``ids`` into a static-size table.

    Returns ``(uniq, inv, n_uniq)``, all int32 on ``ids``' device:

      uniq   [budget] the first ``min(n_uniq, budget)`` distinct values
             in ascending order, int32-max fill past ``n_uniq``
      inv    [n] in [0, budget): ``uniq[inv[i]] == ids[i]`` for every
             counted position whenever ``n_uniq <= budget`` (in range but
             meaningless at excluded positions and on overflow)
      n_uniq [] the true distinct count (may exceed ``budget``)

    ``valid`` (optional [n] bool) excludes positions from the count by
    keying them to int32 max, so ids must stay below it. Equal to the
    JAX function's outputs, fill included. ``collector`` records
    ``DEDUP_CALLS``, ``DEDUP_TOTAL``, ``DEDUP_UNIQUE`` and
    ``DEDUP_OVERFLOW`` on the card, reading nothing back."""
    ids = ids.to(torch.int32)
    key = ids if valid is None else torch.where(
        valid, ids, torch.full_like(ids, I32_MAX))
    skey = torch.sort(key).values
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    new = (first & (skey != I32_MAX)) if valid is not None else first
    n_uniq = new.sum(dtype=torch.int32)
    urank = torch.cumsum(new, 0, dtype=torch.int32) - 1
    tgt = torch.where(new & (urank < budget), urank,
                      torch.full_like(urank, budget))     # budget = drop
    uniq = torch.full((budget + 1,), I32_MAX, dtype=torch.int32,
                      device=ids.device)
    uniq.scatter_(0, tgt.long(), skey)
    uniq = uniq[:budget]
    inv = torch.searchsorted(uniq, key).clamp_(0, budget - 1)
    if collector is not None:
        collector.add(metrics.DEDUP_CALLS, 1)
        collector.add(metrics.DEDUP_TOTAL, ids.shape[0] if valid is None
                      else valid.sum(dtype=torch.int32))
        collector.add(metrics.DEDUP_UNIQUE, n_uniq)
        collector.add(metrics.DEDUP_OVERFLOW, n_uniq > budget)
    return uniq, inv.to(torch.int32), n_uniq


def dedup_take(table, ids: torch.Tensor, budget: int,
               valid=None, collector=None) -> torch.Tensor:
    """``table[clip(ids)]`` reading each distinct id once: the narrow
    read is a ``[budget, dim]`` gather of the unique rows, expanded to
    the positions; on unique overflow the full positional gather is
    taken instead, as the JAX function's ``lax.cond`` does. Rows at
    excluded (``valid=False``) positions are meaningless: callers mask
    them. ``table`` is a tensor or ``QuantizedTensor`` (dequant fused),
    on ``ids``' device or, on a card, in pinned host memory.
    ``collector`` goes to :func:`unique_within_budget` (nothing is
    recorded when ``budget >= len(ids)``, as in JAX)."""
    n = ids.shape[0]
    last = max(quant.tier_rows(table) - 1, 0)
    if budget >= n:
        return gather_rows(table, ids.clamp(0, last).to(torch.int32))
    uniq, inv, n_uniq = unique_within_budget(ids, budget, valid=valid,
                                             collector=collector)
    over = n_uniq > budget
    live = (torch.arange(budget, device=ids.device) < n_uniq) & ~over
    skip = torch.full_like(uniq, -1)
    rows_u = gather_rows(
        table, torch.where(live, uniq.clamp(0, last), skip),
        out=torch.zeros((budget, quant.tier_dim(table)),
                        dtype=quant.tier_dtype(table), device=ids.device))
    x = rows_u.index_select(0, inv.long())
    ids = ids.clamp(0, last).to(torch.int32)
    with gated():
        return gather_rows(table, torch.where(over, ids,
                                              torch.full_like(ids, -1)),
                           out=x)


def unique_np(ids, valid=None) -> np.ndarray:
    """Host-side frontier dedup: the sorted distinct valid ids (numpy).
    ``valid=None`` treats negative ids as padding."""
    ids = ids.detach().cpu().numpy() if torch.is_tensor(ids) \
        else np.asarray(ids)
    mask = ids >= 0
    if valid is not None:
        mask &= valid.detach().cpu().numpy() if torch.is_tensor(valid) \
            else np.asarray(valid)
    return np.unique(ids[mask])


def compact_exchange_slots(ids, cap: int, hosts: int, owner=None) -> int:
    """The compact exchange's branch structure for one rank's batch, on
    the host: request slots shipped per collective direction, ``cap *
    hosts`` on the compact path, the whole batch on overflow (more valid
    unique ids than the ``min(cap * hosts, batch)`` table, or an owner's
    bucket past ``cap``) or when ``cap`` cannot beat the dense block.
    ``owner`` maps id -> owning host (``PartitionInfo.global2host``);
    None models a balanced hash partition (``id % hosts``)."""
    ids = ids.detach().cpu().numpy() if torch.is_tensor(ids) \
        else np.asarray(ids)
    n = int(ids.shape[0])
    if cap is None or cap >= n:
        return n
    uniq = np.unique(ids[ids >= 0])
    if uniq.size > min(cap * hosts, n):
        return n
    if owner is None:
        own = uniq % hosts
    else:
        own = (owner.detach().cpu().numpy() if torch.is_tensor(owner)
               else np.asarray(owner))[uniq]
    if np.bincount(own, minlength=hosts).max(initial=0) > cap:
        return n
    return cap * hosts
