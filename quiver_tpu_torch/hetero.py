"""Heterogeneous graphs: a typed topology and a relational k-hop sampler
(counterpart of ``quiver_tpu/hetero.py``).

- ``HeteroCSRTopo``: one ``CSRTopo`` per relation ``(src_type, rel,
  dst_type)``, its rows the dst-type nodes and its indices src-type ids
  (the sampling direction: a frontier node pulls its in-neighbours).
- ``HeteroGraphSageSampler``: per hop, every relation whose dst type has
  a frontier samples ``k`` neighbours of it; per src type, the old
  frontier and every relation's picks are compacted into the next
  frontier (``ops.sample.compact_union``: old frontier first, keeping
  its slots, then the new ids ascending), and each relation gets its
  local COO against that frontier.

All shapes are static (capacities with -1 fill), so ``sample()`` makes no
host synchronisation on the card. The JAX sampler's jitted function
returns its dicts with their keys sorted; the port returns them sorted
too, so a model summing over relations (``models/rgcn.py``) adds them in
the same order. Random numbers come from one ``torch.Generator``
on the sampler's device, drawn by the relations in the order the JAX
sampler folds its key (``fold_in(key, step)``, ``step`` counting sampled
relations); the picks are held to the JAX package by contract.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.sample import (as_index_rows, as_index_rows_overlapping,
                         compact_union, compose_slot_map, edge_row_ids,
                         reshuffle_csr, sample_layer,
                         sample_layer_exact_wide, sample_layer_rotation,
                         sample_layer_window, suggest_hub_cap)
from .ops.weighted import sample_layer_weighted
from .pyg.sage_sampler import Adj
from .utils.device import resolve_device

EdgeType = Tuple[str, str, str]          # (src_type, relation, dst_type)
_WINDOWED = ("rotation", "window")


def _sorted(d: dict) -> dict:
    """``d`` with its keys in ascending order, as JAX's jit returns a
    dict."""
    return dict(sorted(d.items(), key=lambda kv: kv[0]))


class HeteroCSRTopo:
    """Typed topology: ``rels[(src, rel, dst)] = CSRTopo`` whose row v
    (a dst-type node) lists its src-type in-neighbours."""

    def __init__(self, rels: Dict[EdgeType, object],
                 node_counts: Dict[str, int]):
        self.rels = dict(rels)
        self.node_counts = dict(node_counts)
        for (src, rel, dst), topo in self.rels.items():
            if topo.node_count < self.node_counts.get(dst, 0):
                raise ValueError(
                    f"relation {(src, rel, dst)} CSR has {topo.node_count} "
                    f"rows < dst node_count {self.node_counts[dst]}")

    @property
    def edge_types(self) -> List[EdgeType]:
        return list(self.rels.keys())

    @property
    def node_types(self) -> List[str]:
        return list(self.node_counts.keys())


class HeteroLayer(NamedTuple):
    """One sampled hop of a hetero graph.

    adjs:     {edge_type: Adj}, the local bipartite COO per relation;
              source local ids index the frontier of the src type after
              this hop, target local ids the dst type's frontier before.
    frontier: {node_type: n_id} after this hop (-1 fill, static
              capacity; None for a type not reached yet).
    counts:   {node_type: valid count} of the types this hop extended.
    """

    adjs: Dict[EdgeType, Adj]
    frontier: Dict[str, Optional[torch.Tensor]]
    counts: Dict[str, torch.Tensor]


def assemble_hop(frontier: Dict[str, Optional[torch.Tensor]],
                 samples: Dict[EdgeType, tuple], frontier_cap=None):
    """Steps 2 and 3 of a hop, from the relations' picks:
    ``samples[et] = (cur, nbrs [s, k] -1 fill, e_id slots [s, k] or
    None)`` in sampling order, ``cur`` the dst type's frontier the picks
    were drawn for. Per src type, the old frontier and the picks of
    every relation into it are compacted (``compact_union``) and, under
    ``frontier_cap`` (``{node_type: int}``), cut to the seeds-first
    prefix with every edge whose source fell past the cap masked, its
    ``e_id`` with it. Returns ``(adjs, frontier, counts)``, keys
    sorted."""
    new_frontier = dict(frontier)
    counts: Dict[str, torch.Tensor] = {}
    adjs: Dict[EdgeType, Adj] = {}
    by_src: Dict[str, list] = {}
    for et, (cur, nbrs, slots) in samples.items():
        by_src.setdefault(et[0], []).append((et, nbrs, slots))
    for src_t, group in by_src.items():
        dev = group[0][1].device
        prev = frontier[src_t]
        if prev is None:
            prev = torch.full((0,), -1, dtype=torch.int32, device=dev)
        n_id, n_count, extra_local = compact_union(
            prev, torch.cat([nbrs.reshape(-1) for _, nbrs, _ in group]))
        cap = frontier_cap.get(src_t) if frontier_cap else None
        if cap is not None and n_id.shape[0] > cap:
            # static-capacity truncation: keep the seeds-first prefix,
            # mask the edges whose source fell past the cap
            n_id = n_id[:cap]
            n_count = torch.clamp(n_count, max=cap)
            extra_local = torch.where(extra_local < cap, extra_local, -1)
        new_frontier[src_t] = n_id
        counts[src_t] = n_count
        offset = 0
        for et, nbrs, slots in group:
            s, kk = nbrs.shape
            flat = extra_local[offset:offset + s * kk]
            offset += s * kk
            valid = flat >= 0
            row = torch.where(valid, torch.arange(
                s, dtype=torch.int32, device=dev).repeat_interleave(kk), -1)
            e_id = None if slots is None else \
                torch.where(valid, slots.reshape(-1), -1)
            adjs[et] = Adj(torch.stack([flat, row]), e_id,
                           (int(n_id.shape[0]), s), mask=valid)
    return _sorted(adjs), _sorted(new_frontier), _sorted(counts)


class HeteroGraphSageSampler:
    """Relational neighbour sampler; the JAX sampler's arguments plus
    ``device`` (the card unless ``"cpu"``).

    ``sizes`` is a list of per-hop fanouts, each an int (every relation)
    or a ``{edge_type: k}`` dict; ``sample(seeds)`` takes nodes of
    ``seed_type`` and returns ``(frontier, batch_size, layers)``, the
    layers outermost hop first.

    - ``sampling="exact"``: i.i.d. draws, through each relation's rows
      view (``sample_layer_exact_wide``, the hub budget from the
      relation's ``exact_bucket_meta(step=128)``), or scattered
      (``sample_layer``) with ``wide_exact=False``;
    - ``"rotation"`` / ``"window"``: draws over per-relation shuffled
      rows views that ``reshuffle()`` refreshes (automatic on the first
      ``sample``; ``shuffle="sort"`` or ``"butterfly"``, composed across
      calls); fanouts up to 128;
    - ``layout="overlap"``: one 256-wide row read per seed instead of two
      128-wide ones, at twice the index memory.

    ``frontier_cap`` (an int, or ``{node_type: int}``) bounds each
    type's frontier: edges whose source falls past it are masked.
    ``edge_weight`` (``{edge_type: CSR-slot-aligned weights}``) makes
    those relations weighted draws (``sample_layer_weighted``, with
    replacement), exact mode only. ``with_eid`` stamps each sampled edge
    with its edge id (the relation's ``CSRTopo.eid`` where it has one,
    else the CSR slot; under rotation and window through per-relation
    co-permuted maps composed across reshuffles), -1 where masked."""

    def __init__(self, topo: HeteroCSRTopo, sizes: Sequence,
                 seed_type: str, seed: int = 0, sampling: str = "exact",
                 layout: str = "pair", shuffle: str = "sort",
                 frontier_cap=None, wide_exact: bool = True,
                 edge_weight: Optional[Dict[EdgeType, object]] = None,
                 with_eid: bool = False, device=None):
        self.topo = topo
        self.seed_type = seed_type
        self.sizes = [s if isinstance(s, dict)
                      else {et: s for et in topo.edge_types}
                      for s in sizes]
        if sampling not in ("exact",) + _WINDOWED:
            raise ValueError(f"unknown sampling method {sampling!r}")
        if layout not in ("pair", "overlap"):
            raise ValueError(f"unknown layout {layout!r}")
        if shuffle not in ("sort", "butterfly"):
            raise ValueError(f"unknown shuffle {shuffle!r}")
        max_k = max((k for hop in self.sizes for k in hop.values()),
                    default=0)
        if sampling in _WINDOWED and max_k > 128:
            raise ValueError(f"{sampling} sampling supports fanouts <= 128")
        self.sampling = sampling
        self.layout = layout
        self.shuffle = shuffle
        if frontier_cap is not None and not isinstance(frontier_cap, dict):
            frontier_cap = {t: int(frontier_cap) for t in topo.node_types}
        self.frontier_cap = frontier_cap
        self.wide_exact = wide_exact
        if edge_weight is not None:
            unknown = set(edge_weight) - set(topo.rels)
            if unknown:
                raise ValueError(
                    f"edge_weight for unknown relation(s) "
                    f"{sorted(unknown)}")
            if sampling != "exact":
                # the weighted windowed draw's hub re-placement exists
                # only on the homogeneous sampler's rotation/window path
                raise ValueError(
                    "per-relation weighted draws support "
                    "sampling='exact' only (rotation/window would need "
                    "the weighted windowed draw's co-permuted weight "
                    "rows — use the homogeneous GraphSageSampler for "
                    "that workload)")
            for et, w in edge_weight.items():
                e = int(topo.rels[et].indices.shape[0])
                if int(np.shape(w)[0]) != e:
                    raise ValueError(
                        f"edge_weight[{et}] has {int(np.shape(w)[0])} "
                        f"entries, relation has {e} edges")
        self.edge_weight = edge_weight
        self.with_eid = with_eid
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(seed)
        self._weights_placed = None
        self._eids_placed = None
        self._rot_eids = {}      # {edge_type: permuted slot -> edge id}
        self._hub_fracs = None   # {edge_type: hub fraction}
        self._rows = None        # {edge_type: rows view}
        self._permuted = {}      # butterfly composition state
        self._row_ids = {}
        self._rels_placed = None  # {edge_type: (indptr, indices)}

    def _as_rows(self, flat):
        return (as_index_rows_overlapping(flat)
                if self.layout == "overlap" else as_index_rows(flat))

    @property
    def _stride(self):
        return 128 if self.layout == "overlap" else None

    def _placed(self):
        """Every relation's ``(indptr, indices)`` on the sampler's
        device, moved once."""
        if self._rels_placed is None:
            self._rels_placed = {
                et: (t.indptr.to(self.device), t.indices.to(self.device))
                for et, t in self.topo.rels.items()}
        return self._rels_placed

    def _eid_base(self, et):
        """The relation's ``CSRTopo.eid`` on the device (placed once), or
        None without one."""
        t = self.topo.rels[et]
        if t.eid is None:
            return None
        if self._eids_placed is None:
            self._eids_placed = {}
        if et not in self._eids_placed:
            self._eids_placed[et] = t.eid.to(self.device)
        return self._eids_placed[et]

    def reshuffle(self, generator: Optional[torch.Generator] = None):
        """Per-epoch refresh of every relation's shuffled rows view, the
        freshness source of rotation and window (exact mode needs none
        and raises). Relations shuffle in sorted order, drawing from the
        sampler's generator unless one is given."""
        if self.sampling not in _WINDOWED:
            raise ValueError(
                "reshuffle only applies to rotation/window sampling")
        gen = self.generator if generator is None else generator
        bfly = self.shuffle == "butterfly"
        rels = self._placed()
        rows = {}
        for et in sorted(self.topo.rels):
            indptr, indices = rels[et]
            rid = self._row_ids.get(et)
            if rid is None:
                rid = edge_row_ids(indptr, int(indices.shape[0]))
                self._row_ids[et] = rid
            src = self._permuted.get(et, indices) if bfly else indices
            out = reshuffle_csr(src, rid, gen, method=self.shuffle,
                                with_slot_map=self.with_eid)
            if self.with_eid:
                permuted, smap = out
                self._rot_eids[et] = compose_slot_map(
                    self._rot_eids.get(et), smap, self._eid_base(et), bfly)
            else:
                permuted = out
            if bfly:
                self._permuted[et] = permuted
            rows[et] = self._as_rows(permuted)
        self._rows = rows

    def _sample_relation(self, et, cur, k, rows, rels, weights):
        """One relation's ``(nbrs [s, k], slots [s, k] or None)``."""
        indptr, indices = rels[et]
        gen, track = self.generator, self.with_eid
        w = weights.get(et)
        if w is not None:
            out = sample_layer_weighted(indptr, indices, w, cur, k, gen,
                                        with_slots=track)
        elif self.sampling == "rotation":
            out = sample_layer_rotation(indptr, rows[et], cur, k, gen,
                                        with_slots=track,
                                        stride=self._stride)
        elif self.sampling == "window":
            out = sample_layer_window(indptr, rows[et], cur, k, gen,
                                      with_slots=track, stride=self._stride)
        elif rows is not None:
            hub_frac = (self._hub_fracs or {}).get(et)
            out = sample_layer_exact_wide(
                indptr, indices, rows[et], cur, k, gen, stride=self._stride,
                with_slots=track,
                hub_cap=suggest_hub_cap(int(cur.shape[0]), hub_frac))
        else:
            out = sample_layer(indptr, indices, cur, k, gen,
                               with_slots=track)
        return out[0], (out[2] if track else None)

    def sample(self, seeds):
        """``(frontier, batch_size, layers)``: the final per-type
        frontier, the seed count, and one ``HeteroLayer`` per hop,
        outermost first. Every dict's keys are sorted."""
        seeds = torch.as_tensor(seeds).to(self.device, torch.int32)
        bs = int(seeds.shape[0])
        if self.frontier_cap is not None and \
                self.frontier_cap.get(self.seed_type, bs) < bs:
            raise ValueError(
                f"frontier_cap[{self.seed_type!r}] = "
                f"{self.frontier_cap[self.seed_type]} < batch size {bs}: "
                "the cap would truncate the seeds themselves")
        rels = self._placed()
        if self._rows is None:
            if self.sampling in _WINDOWED:
                self.reshuffle()
            elif self.wide_exact:
                # weighted relations draw from their pool: no view for them
                self._rows = {et: self._as_rows(rels[et][1])
                              for et in self.topo.rels
                              if not (self.edge_weight
                                      and et in self.edge_weight)}
                self._hub_fracs = {
                    et: float(self.topo.rels[et]
                              .exact_bucket_meta(step=128).frac)
                    for et in self._rows}
        if self.edge_weight is not None and self._weights_placed is None:
            self._weights_placed = {
                et: torch.as_tensor(w).to(self.device, torch.float32)
                for et, w in self.edge_weight.items()}
        eids = {}
        if self.with_eid:
            # rotation/window slots are positions in the shuffled order:
            # they map through the co-permuted maps instead
            eids = dict(self._rot_eids) if self.sampling in _WINDOWED \
                else {et: self._eid_base(et) for et in self.topo.rels
                      if self.topo.rels[et].eid is not None}
        frontier = {t: None for t in self.topo.node_types}
        frontier[self.seed_type] = seeds
        layers = []
        for fanouts in self.sizes:
            samples = {}
            for et, k in fanouts.items():
                cur = frontier[et[2]]
                if cur is None or k <= 0:
                    continue
                nbrs, slots = self._sample_relation(
                    et, cur, k, self._rows, rels, self._weights_placed or {})
                if slots is not None and et in eids:
                    e = eids[et]
                    slots = torch.where(
                        slots >= 0, e[slots.long().clamp(0, e.shape[0] - 1)]
                        .to(slots.dtype), -1)
                samples[et] = (cur, nbrs, slots)
            adjs, frontier, counts = assemble_hop(frontier, samples,
                                                  self.frontier_cap)
            layers.append(HeteroLayer(adjs=adjs, frontier=frontier,
                                      counts=counts))
        return frontier, bs, layers[::-1]
