"""Analytic cost model on the one recorded run (counterpart of
``quiver_tpu/analysis/costmodel.py``): the profiler's "modeled" half.

``op_lint`` checks a recorded run against budgets; this module prices
the same recording in absolute units, so the profiler
(``quiver_tpu_torch.profile``) can divide modeled bytes by measured time
and compare against the machine probe's peaks. One recording per entry
yields:

- **FLOPs**: ``torch.utils.flop_counter``'s formulas over the aten ops
  (2·M·N·K a product, the backward's products included), plus the
  kernels' own (the int8 leaf hop's decode, 2 per value written);
- **gather bytes**: every aten index op's output, and every kernel
  call priced by the formulas below on this run's data (the bytes it
  must move: each distinct row once, the ids, the rows written), plus
  the index tensors feeding the aten gathers (``gather_index_bytes``,
  each index storage once);
- **collective bytes**: the payloads of the recorded collectives;
- **input and output bytes**: full reads of every entry argument whose
  storage no gather or kernel consumed, and the writes of every output
  no kernel wrote (a kernel's outputs are priced in its own bytes);
- **per-tier bytes**: the rows each declared tier served, at gate depth
  0, times its row bytes.

A predicated branch (``_build.gated``, JAX's ``lax.cond``) contributes
nothing to the floor, as JAX's minimum over a cond's branches does: its
bytes go to ``cond_extra_bytes``. An eager run has no loop of unknown
trip count, so ``while_loops`` stays 0.

The byte formulas ``chip_smoke.py`` prints its kernels' bounds from live
here (:func:`sample_hop_bytes`, :func:`hot_hop_cost`,
:func:`gather_rows_bytes`, :func:`served_batch_bytes`), so the smoke
script's bounds and the profiler's roofline read one count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import torch

from ..ops import quant
from .op_lint import (EntrySpec, KernelCall, Recording, _leaves, _nbytes,
                      overlaps, record, storage_key, storages,
                      tier_components, tier_reads)


@dataclass
class CostModel:
    """The priced recording of one entry point or stage. Byte fields
    are the floor (a gated branch's bytes on ``cond_extra_bytes``)."""

    flops: int = 0
    gather_bytes: int = 0
    gather_index_bytes: int = 0
    collective_bytes: int = 0
    input_bytes: int = 0          # arguments no gather read, in full
    output_bytes: int = 0         # outputs no kernel wrote
    tier_bytes: Dict[str, int] = field(default_factory=dict)
    cond_extra_bytes: int = 0
    while_loops: int = 0

    @property
    def total_bytes(self) -> int:
        """The roofline numerator: gathered rows and their index
        buffers, collective payloads, full reads of the other inputs,
        and output writes."""
        return int(self.gather_bytes + self.gather_index_bytes
                   + self.collective_bytes + self.input_bytes
                   + self.output_bytes)

    def record(self) -> dict:
        """JSONL-ready payload (the ``modeled`` block of a ``profile``
        record), JAX's keys."""
        rec = {
            "flops": int(self.flops),
            "gather_bytes": int(self.gather_bytes),
            "gather_index_bytes": int(self.gather_index_bytes),
            "collective_bytes": int(self.collective_bytes),
            "input_bytes": int(self.input_bytes),
            "output_bytes": int(self.output_bytes),
            "total_bytes": self.total_bytes,
        }
        if self.cond_extra_bytes:
            rec["cond_extra_bytes"] = int(self.cond_extra_bytes)
        if self.while_loops:
            rec["while_loops"] = int(self.while_loops)
        if self.tier_bytes:
            rec["tier_bytes"] = dict(self.tier_bytes)
        return rec


# ---------------------------------------------------------------------------
# the kernels' byte formulas (the bounds chip_smoke.py prints)
# ---------------------------------------------------------------------------


def sample_hop_bytes(seeds, k, counts) -> int:
    """Least bytes of a sampling hop: the seeds, each valid seed's
    indptr pair, each pick's index entry, and the outputs."""
    bs = seeds.shape[0]
    valid = int((seeds >= 0).sum())
    return 4 * bs + 8 * valid + 4 * int(counts.long().sum()) \
        + 4 * bs * k + 4 * bs


def hot_hop_cost(seeds, k, counts, nbrs, feat, forder, hot_rows):
    """(bytes, fp32 ops) the leaf hop needs on this run's data: the
    sampling bytes, each distinct hot storage row once (codes and
    sidecars), the order entries of the distinct ids, and the fp32 rows
    written for every seed and pick."""
    ids = torch.cat([seeds, nbrs.reshape(-1)]).long()
    ids = torch.unique(ids[ids >= 0])
    rows = ids
    extra = 0
    if forder is not None:
        rows = forder.long()[ids]
        rows = rows[rows < hot_rows]
        extra = 4 * ids.numel()
    nrows = int(torch.unique(rows).numel())
    dim = quant.tier_dim(feat)
    bs = seeds.shape[0]
    nbytes = sample_hop_bytes(seeds, k, counts) + extra \
        + nrows * quant.row_read_bytes(feat) + 4 * dim * bs * (1 + k)
    ops = 2 * dim * bs * (1 + k) if quant.is_quantized(feat) else 0
    return nbytes, ops


def gather_rows_bytes(tab, ids):
    """``(table bytes, device bytes, distinct rows)`` of a row gather:
    each distinct live row's data bytes (codes and sidecars, not a
    packed row's padding) read once from the table, and the ids read
    and the fp32 rows written on the ids' side. Negative ids read
    nothing."""
    live = ids[ids >= 0]
    distinct = int(torch.unique(live).numel())
    table_bytes = distinct * quant.row_read_bytes(tab)
    dim = tab.dim if quant.is_sharded(tab) else quant.tier_dim(tab)
    dev_bytes = ids.shape[0] * 4 + live.shape[0] * 4 * dim
    return table_bytes, dev_bytes, distinct


def served_batch_bytes(eng, seeds, hop_seeds, sizes, row_cap) -> int:
    """The least bytes one served batch of a ``ServeEngine`` over a
    tiered ``Feature`` store moves: each hop's sampling bytes (as
    :func:`sample_hop_bytes`), each distinct frontier row once from its
    tier (hot codes and sidecars on the card, cold from the pinned
    tier), and the fp32 rows written."""
    from ..ops.kernels import fused
    seeds = eng.pad_seeds(seeds)
    n_id, layers = fused.fused_sample_multihop(
        eng._indptr, eng._indices, seeds, list(sizes), hop_seeds, row_cap)
    total, cur = 0, seeds
    for k, layer in zip(sizes, layers):
        bs = cur.shape[0]
        total += 4 * bs + 8 * int((cur >= 0).sum()) \
            + 4 * int(layer.edge_count) + 4 * bs * k + 4 * bs
        cur = layer.n_id
    store = eng._store
    live = torch.unique(n_id[n_id >= 0].long())
    rows = store.feature_order.long()[live]
    hot = int((rows < store.cache_rows).sum())
    total += hot * quant.row_read_bytes(store.device_part) \
        + (live.numel() - hot) * quant.row_read_bytes(store._host_offload) \
        + 4 * quant.tier_dim(store.device_part) * n_id.shape[0]
    return int(total)


def _arg(call: KernelCall, i: int, name: str, default=None):
    if len(call.args) > i:
        return call.args[i]
    return call.kwargs.get(name, default)


def kernel_cost(call: KernelCall) -> Tuple[int, int]:
    """(bytes, FLOPs) of one kernel call on its recorded data."""
    n = call.name
    if n in ("fused_sample_hop", "sample_layer_kernel"):
        _, counts = call.out
        return sample_hop_bytes(_arg(call, 2, "seeds"), int(_arg(
            call, 3, "k")), counts), 0
    if n == "fused_hot_hop":
        nbrs, counts = call.out[0], call.out[1]
        feat = _arg(call, 3, "feat")
        forder = _arg(call, 7, "feature_order")
        hot = _arg(call, 8, "hot_rows")
        if hot is None:
            hot = quant.tier_rows(feat)
        return hot_hop_cost(_arg(call, 2, "seeds"), int(_arg(call, 4, "k")),
                            counts, nbrs, feat, forder, hot)
    if n in ("gather_rows", "gather_rows_sharded"):
        tb, db, _ = gather_rows_bytes(call.args[0], call.args[1])
        return tb + db, 0
    if n == "gather_elems":
        table, ids = call.args[0], call.args[1]
        live = int((ids >= 0).sum())
        return 4 * ids.shape[0] + 2 * live * table.element_size(), 0
    if n == "gather_segments":
        table, start, count, width = call.args[:4]
        read = int(count.clamp(0, int(width)).sum())
        return 8 * start.shape[0] + read * table.element_size() \
            + start.shape[0] * int(width) * table.element_size(), 0
    return 0, 0


def cost_of_recording(rec: Recording, args: Sequence = (),
                      tiers: Tuple = ()) -> CostModel:
    """Price one recording (see the module docstring). ``args`` are the
    entry's arguments (for the full-read inputs), ``tiers`` the declared
    tiers to break gather traffic out per tier."""
    m = CostModel(flops=int(rec.flops))
    consumed, written, index_seen = set(), set(), set()
    extra = 0
    for g in rec.gathers:
        consumed.add(storage_key(g.table))
        consumed.add(g.index_key)
        idx = g.index_bytes if g.index_key not in index_seen else 0
        index_seen.add(g.index_key)
        if g.depth == 0:
            m.gather_bytes += g.out_bytes
            m.gather_index_bytes += idx
        else:
            extra += g.out_bytes + idx
    for call in rec.kernels:
        consumed |= storages((call.args, call.kwargs))
        written |= storages(call.out)
        nbytes, flops = kernel_cost(call)
        if call.depth == 0:
            m.gather_bytes += nbytes
            m.flops += flops
        else:
            extra += nbytes
    for c in rec.collectives:
        if c.depth == 0:
            m.collective_bytes += c.nbytes
        else:
            extra += c.nbytes
    m.cond_extra_bytes = int(extra)
    seen = set()
    for t in _leaves(args):
        k = storage_key(t)
        if k not in seen and k not in consumed:
            m.input_bytes += _nbytes(t)
        seen.add(k)
    seen = set()
    for t in _leaves(rec.out):
        k = storage_key(t)
        if k not in seen and k not in written:
            m.output_bytes += _nbytes(t)
        seen.add(k)
    reads = tier_reads(rec)
    for tier in tiers:
        comps = tier_components(tier)
        rngs = [r for r, _ in comps]
        rows = sum(r for s, r, d in reads if d == 0 and overlaps(s, rngs))
        label = comps[0][1] if comps else "?"
        row_b = quant.row_read_bytes(tier)
        m.tier_bytes[label] = m.tier_bytes.get(label, 0) + rows * row_b
    return m


def cost_of(spec: EntrySpec) -> CostModel:
    """Price one registered entry point on its one recorded run (the
    same cached ``spec.recording()`` the verifier rules read)."""
    return cost_of_recording(spec.recording(), spec.args,
                             tuple(t for t, _, _ in spec.tier_budgets))


def cost_of_fn(fn, args, tiers: Tuple = ()) -> CostModel:
    """Price an arbitrary callable by recording one run of it (the
    profiler's pipeline stages, which are not registry entries)."""
    return cost_of_recording(record(fn, args), args, tiers)

