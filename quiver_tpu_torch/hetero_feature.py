"""Per-node-type tiered feature stores for heterogeneous graphs
(counterpart of ``quiver_tpu/hetero_feature.py``).

``HeteroFeature`` keeps one ``Feature`` per node type, each with its own
budget, tiers and dtype policy: a MAG240M-shaped configuration keeps the
large paper matrix int8 with a degree-ordered hot tier on the card and
its cold tier pinned in host memory (read by the card's ``gather_rows``),
while the small author and institution matrices sit on the card.

A type's store may also be a clique (``cache_policy=
"p2p_clique_replicate"`` with a ``mesh``): its hot tier row-sharded over
the mesh and read by one ``gather_rows_sharded`` launch, beside types
whose tiers are replicated (JAX ``test_mesh_sharded_type``).

``lookup(frontier)`` takes the hetero sampler's per-type frontier dicts
as they are: ``None`` entries are skipped and -1 ids give zero rows.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from .feature import Feature


class _StagedLookup(Future):
    """The future :meth:`HeteroFeature.prefetch` returns. The worker sets
    it to ``(rows, done)``, ``done`` the CUDA event recorded on each
    card's staging stream after its lookups. ``result()`` returns the
    rows dict, and on the card first makes the caller's current stream
    of each row tensor's device wait for that device's event and records
    the rows' use on it (so the caching allocator does not hand their
    memory back to the staging stream early). Nothing waits for the
    card."""

    def result(self, timeout=None):
        rows, done = super().result(timeout)
        for t in rows.values():
            ev = done.get(t.device)
            if ev is not None:
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(ev)
                t.record_stream(stream)
        return rows


class HeteroFeature:
    """``{node_type: Feature}`` with a frontier-shaped lookup.

    Build it with :meth:`from_cpu_tensors`: ``configs[node_type]``
    overlaid on ``default``, both keyword dicts for :class:`Feature`
    (``device_cache_size``, ``csr_topo``, ``dtype``, ``host_placement``,
    ``cold_budget``, ``dedup_cold``, ``dtype_policy``, ``cache_policy``,
    ``mesh``, ``device``...).
    Hetero frontiers repeat hub nodes across relations, so
    ``default={"dedup_cold": True}`` bounds each type's host reads by
    its distinct cold rows; ``configs={"paper": {"dtype_policy":
    "int8"}}`` keeps the large paper matrix int8."""

    def __init__(self, stores: Dict[str, Feature]):
        self.stores = dict(stores)
        self._pool = None
        self._streams = {}       # {device: prefetch's staging stream}

    @classmethod
    def from_cpu_tensors(cls, feats: Dict[str, np.ndarray],
                         configs: Optional[Dict[str, dict]] = None,
                         default: Optional[dict] = None) -> "HeteroFeature":
        configs = configs or {}
        default = default or {}
        unknown = set(configs) - set(feats)
        if unknown:
            raise ValueError(
                f"configs for unknown node type(s) {sorted(unknown)}; "
                f"have {sorted(feats)}")
        stores = {}
        for t, arr in feats.items():
            kw = dict(default)
            kw.update(configs.get(t, {}))
            stores[t] = Feature(**kw).from_cpu_tensor(arr)
        return cls(stores)

    @property
    def node_types(self):
        return list(self.stores.keys())

    def __getitem__(self, node_type: str) -> Feature:
        return self.stores[node_type]

    def _lookup_one(self, node_type: str, ids):
        return self.stores[node_type].getitem_masked(ids)

    def lookup(self, frontier: Dict[str, object]) -> Dict[str, object]:
        """Rows for a hetero frontier dict (``None`` entries skipped, -1
        ids giving zero rows), in the frontier's key order."""
        return {t: self._lookup_one(t, ids)
                for t, ids in frontier.items() if ids is not None}

    def prefetch(self, frontier: Dict[str, object]):
        """Start ``lookup(frontier)`` on the staging pipeline and return
        a ``concurrent.futures.Future`` whose ``result()`` equals it bit
        for bit: the host-tier reads of batch i+1 overlap batch i's
        model step. Depth 2, in order, stopped by :meth:`close` (or when
        the store is collected).

        The ids are copied before this returns. On the card, per device,
        an event recorded on the caller's current stream (the ids'
        producer) orders the lookups, which the worker runs on that
        device's own staging stream, and ``result()`` orders the
        reader's stream after them: neither thread waits for the card."""
        if self._pool is None:
            from .pipeline import Pipeline
            self._pool = Pipeline(depth=2, name="quiver-hetero-prefetch",
                                  future_type=_StagedLookup)
        snap = {t: None if ids is None else
                self.stores[t]._ids(ids).clone()
                for t, ids in frontier.items()}
        ready = {}
        for ids in snap.values():
            if ids is None or ids.device.type != "cuda":
                continue
            dev = ids.device
            if dev not in ready:
                stream = self._streams.get(dev)
                if stream is None:
                    stream = self._streams[dev] = torch.cuda.Stream(dev)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ready[dev] = (stream, ev)
            ids.record_stream(ready[dev][0])
        return self._pool.submit(self._staged, snap, ready)

    def _staged(self, snap, ready):
        """The worker's half of :meth:`prefetch`: ``(rows, done)``."""
        rows, done = {}, {}
        for dev, (stream, ev) in ready.items():
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(ev)
                for t, ids in snap.items():
                    if ids is not None and ids.device == dev:
                        rows[t] = self._lookup_one(t, ids)
                done[dev] = torch.cuda.Event()
                done[dev].record(stream)
        for t, ids in snap.items():
            if ids is not None and ids.device.type != "cuda":
                rows[t] = self._lookup_one(t, ids)
        return {t: rows[t] for t in snap if t in rows}, done

    def close(self):
        """Stop the prefetch pipeline and every store's (idempotent)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()
        for store in self.stores.values():
            store.close()

    def size(self, node_type: str, dim: int) -> int:
        return self.stores[node_type].size(dim)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_pool"] = None
        state["_streams"] = {}
        return state
