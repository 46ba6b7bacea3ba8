"""Point-query GNN serving (counterpart of the serve step and
``ServeEngine`` of ``quiver_tpu/serving.py``).

Two routes. ``fused_hot_hop=True`` serves through the fused frontier
walk: interior hops run the CUDA sampling kernel, the leaf hop samples
and gathers the hot-tier rows (int8 dequant included) in one kernel.
Over a clique store (``Feature(cache_policy="p2p_clique_replicate")``,
whose hot tier is row-sharded over several cards or allocations) the
fused route samples every hop with the sampling kernel and then reads
the frontier through the store's lookup, whose hot rows come from one
``gather_rows_sharded`` launch, as ``ShardedServeEngine`` reads its
frontier after sampling. ``fused_hot_hop=False`` is the split path:
the sampler of ``method`` (``ops.sample_multihop``: exact, or rotation and window, which permute
the topology on every call as the JAX serve step's do) on every hop,
then the masked row gather. The model, any module with ``forward(x,
adjs, generator=None)`` (``GraphSAGE``, ``GAT``), runs on the assembled
block either way. ``dedup_gather`` swaps
the split path's gather for ``dedup_feature_gather``. A tiered
``Feature`` store serves through its own lookup: on the fused route the
leaf kernel gathers only the hot tier and the frontier's cold slots are
overlaid from the store's lookup (the cold fixup), whose host rows the
card reads from pinned memory. ``collect_metrics`` makes each step also
return its device counter vector (``metrics.Collector``; the engine
keeps it on ``last_counters``), and ``ServeEngine.refresh_feature``
re-splices a store's tiers after ``Feature.rotate_hot_set``.

``MicroBatchServer`` is the request path over an engine (ROADMAP Queue
1, item 1, *MicroBatchServer*): ``submit(node_id)`` admits one point
query into a bounded queue and returns a ``concurrent.futures.Future``;
a coalescer thread drains the queue into ``[batch_cap]`` seed blocks
(duplicate ids in one batch share a slot), a max-wait deadline bounds
how long a lone request waits for company, and a ``pipeline.Pipeline``
worker (the executor) runs each block through ``ServeEngine.run`` and
reads the logits back to the host with one device-to-host copy, so
batch i+1 coalesces while batch i runs. Overload degrades in two
stages: queue pressure or a burning ``metrics.SloBudget`` sheds
quality (a cheaper fanout variant of the engine's ladder, with
hysteresis), a full queue sheds load (``OverloadError`` at the door).
An optional ``{name: TenantClass}`` registry makes shed order policy
(best effort first, interactive last) and files per-class accounting;
``health()``, ``snapshot()`` and the ``serve.*`` spans of ``tracing``
(under a client's propagated trace id) are its observability. Its RPC
front end is ``rpc.RpcServer``.

The JAX step threads a JAX random key and derives each hop's kernel
seed from it on the device. Here each hop's int32 seed is explicit:
``ServeEngine`` draws them on the host from its own ``torch.Generator``
(no device synchronisation), and ``run(seeds, hop_seeds=...)`` takes
them from the caller. The split path seeds its sampler's generator with
``hop_seeds[0]``.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import faults, metrics, tracing
from .comm import default_exchange_cap, dist_lookup_local
from .ops import quant
from .profiling import hot_path
from .ops.kernels.fused import fused_sample_multihop
from .ops.sample_multihop import sample_multihop
from .parallel.mesh import axis_index, axis_size
from .pyg.sage_sampler import layer_shapes
from .parallel.train import (_dedup_gather_fn, _step_knobs, _walk,
                             draw_int32, layers_to_adjs)
from .utils.csr import INT32_MAX
from .utils.device import resolve_device
from .utils.placement import pinned_put
# the typed request failures are the RPC plane's (rpc.py imports only
# faults and tracing): ServerClosed = "this replica will never answer;
# go elsewhere", DeadlineExceeded = "the budget is spent; retrying
# cannot help"
from .rpc import DeadlineExceeded, ServerClosed

_log = logging.getLogger("quiver_tpu_torch.serving")


def build_serve_step(model, sizes: Sequence[int], batch_cap: int,
                     method: str = "exact", dedup_gather=None,
                     gather=None, collect_metrics: bool = False,
                     fused_hot_hop: bool = False,
                     fused_row_cap: int = 2048,
                     fused_hot_rows: Optional[int] = None):
    """Point-inference step for one fanout config.

    Returns ``step(hop_seeds, feat, forder, indptr, indices, seeds)`` ->
    logits ``[batch_cap, out_dim]``, or ``(logits, counters)`` with
    ``collect_metrics=True``: the ``[metrics.NUM_COUNTERS]`` int32
    vector on the device, with the final frontier's valid slots and
    capacity, the store's metered lookup in the gather (absorbed) and
    the dedup gather's statistics, counted without a host
    synchronisation; the logits are the unmetered step's, bit for bit.
    ``seeds`` is ``[batch_cap]`` int32, distinct valid ids first, -1
    fill at the tail; rows of padded slots are garbage. ``hop_seeds``
    holds one int32 kernel seed per hop.
    ``model`` is any module with ``forward(x, adjs, generator=None)``
    (``GraphSAGE``, ``GAT``) in eval mode on the data's device.
    ``fused_hot_hop=True`` (``method="exact"``) walks through the fused
    kernels, hop ``i`` seeded with ``hop_seeds[i]``;
    ``fused_hot_hop=False`` samples every hop with ``method`` from one
    generator seeded with ``hop_seeds[0]`` (rotation and window with no
    rows view: one ``permute_csr`` of the topology per call, drawn from
    that generator after the hops' draws).

    ``dedup_gather`` (True or an int unique budget; split route only)
    gathers through ``dedup_feature_gather``. ``gather`` replaces the
    whole gather, ``gather(feat, n_id, forder)``: the engine's splice of
    a ``Feature`` store's lookup, where ``feat`` is ``(device_part,
    host_tier)``. On the fused route it needs ``fused_hot_rows`` (the
    hot tier's row count): the leaf kernel reads ``feat[0]`` and zeroes
    every frontier slot whose storage row is not hot, and those slots,
    and only those, are overlaid from ``gather`` (the cold fixup). A
    metered step calls ``gather`` with a ``collector=`` keyword."""
    sizes = [int(k) for k in sizes]
    if gather is None:
        gather = _dedup_gather_fn(dedup_gather)
    fused = _step_knobs(fused_hot_hop, fused_row_cap, sizes, method,
                        dedup_gather)
    if fused is not None and gather is not None and fused_hot_rows is None:
        raise ValueError(
            "fused_hot_hop over a spliced tiered gather needs "
            "fused_hot_rows (the hot-tier row count) to route cold "
            "picks back through the tiered lookup")

    @hot_path
    def step(hop_seeds, feat, forder, indptr, indices, seeds):
        col = metrics.Collector(seeds.device) if collect_metrics else None
        with torch.inference_mode():
            if fused is None:
                x, layers = _walk(None, feat, forder, indptr, indices,
                                  seeds, sizes, hop_seeds, gather=gather,
                                  collector=col, method=method)
            else:
                hot = feat[0] if gather is not None else feat
                if quant.is_sharded(hot):
                    # a clique's hot tier: the sample-only walk, then the
                    # store's lookup (or the sharded gather) of the
                    # frontier
                    x, layers = _walk(fused, feat, forder, indptr, indices,
                                      seeds, sizes, hop_seeds, gather=gather,
                                      collector=col)
                else:
                    x, layers = _walk(fused, hot, forder, indptr, indices,
                                      seeds, sizes, hop_seeds,
                                      hot_rows=fused_hot_rows, collector=col)
                    if gather is not None:
                        x = _cold_fixup(gather, feat, forder,
                                        layers[-1].n_id, x, fused_hot_rows,
                                        col)
            adjs = layers_to_adjs(layers, batch_cap, sizes)
            logits = model(x, adjs)[:batch_cap]
            if col is None:
                return logits
            return logits, col.counters()

    return step


def sample_multihop_serving(indptr, indices, seeds, sizes, generator,
                            method="exact", collector=None):
    """The split path's sampling stage: ``ops.sample_multihop`` under
    the serve step's batch contract (distinct valid seeds first, -1 tail
    fill, so ``seeds_dense``), every hop drawing from ``generator``."""
    return sample_multihop(indptr, indices, seeds, sizes, generator,
                           method=method, seeds_dense=True,
                           collector=collector)


def _cold_fixup(gather, feat, forder, n_id, x, hot_rows: int,
                collector=None):
    """Overlay the cold slots of the fused walk's ``x``: the kernel
    zeroed every frontier slot whose storage row is at or past
    ``hot_rows``; those slots come from the store's lookup, and the hot
    slots are given -1 so the store reads nothing for them. The final
    layer's ``n_id`` is the whole walk's frontier. A ``collector`` gets
    the lookup's counters, which, as in JAX, count the -1 hot slots as
    padding: 0 hot rows, and the frontier's cold slots as cold rows."""
    safe = n_id.long().clamp(min=0)
    t = forder.long()[safe] if forder is not None else safe
    is_cold = (n_id >= 0) & (t >= hot_rows)
    ids = torch.where(is_cold, n_id, -1)
    x_cold = gather(feat, ids, forder) if collector is None else \
        gather(feat, ids, forder, collector=collector)
    return torch.where(is_cold[:, None], x_cold, x)


def _feature_gather(feature):
    """Splice a ``Feature`` store's lookup into the serve step: returns
    ``(feat_args, forder, gather)``, ``feat_args`` being the
    ``(device_part, host_tier)`` pair the step passes through and
    ``gather`` the store's masked tiered lookup on it. A cold tier kept
    for the host path is pinned here once (on the CPU it stays a plain
    tensor), so no batch waits on a host round trip. A store with no
    cold tier returns ``(device_part, feature_order, None)``: the
    default masked gather over the hot tier is its lookup.

    The pinned cold tier is the engine's own copy, as in JAX, where it
    is committed once: on the CPU, where nothing is pinned, it is
    copied too, so a rotation (which updates the store's host tier in
    place) never reaches an engine that has not refreshed. A store with
    a disk tier is refused, as in JAX: its cold reads are driven by the
    host."""
    if feature.mmap_array is not None:
        raise ValueError(
            "ServeEngine cannot fuse a disk/mmap-tier Feature store "
            "(its cold reads are host-driven); serve from a store whose "
            "tiers are HBM/host arrays")
    host = feature._host_offload
    if host is None and feature.host_part is not None:
        host = pinned_put(feature.host_part, feature.device,
                          "the serving cold tier")
        host = _unshared(host, feature.host_part)
    if host is None:
        return feature.device_part, feature.feature_order, None

    def gather(feat_args, n_id, forder, collector=None):
        dev, host_t = feat_args
        if collector is None:
            return feature._lookup_tiered(dev, host_t, n_id, forder, True)
        inner = metrics.Collector(n_id.device)
        rows = feature._lookup_tiered(dev, host_t, n_id, forder, True,
                                      inner)
        collector.absorb(inner.counters())
        return rows
    return (feature.device_part, host), feature.feature_order, gather


def _unshared(tier, src):
    """``tier`` with every storage leaf that shares memory with ``src``'s
    replaced by a copy."""
    if quant.is_quantized(tier):
        return quant.QuantizedTensor(*(
            t.clone() if t.data_ptr() == s.data_ptr() else t
            for t, s in zip(tier, src)))
    return tier.clone() if tier.data_ptr() == src.data_ptr() else tier


def _tier_signature(feat):
    """The shapes and dtypes of the storage leaves of the engine's
    feature argument: a tier, or a ``(device_part, host_tier)`` pair."""
    if quant.is_sharded(feat):
        return [_tier_signature(t) for t in feat.shards]
    if feat is None or torch.is_tensor(feat):
        return None if feat is None else (tuple(feat.shape), feat.dtype)
    return [_tier_signature(t) for t in feat]


def _to_device_tier(feat, device):
    if quant.is_sharded(feat):
        return feat
    if quant.is_quantized(feat):
        return quant.QuantizedTensor(
            *(t.to(device).contiguous() for t in feat))
    return torch.as_tensor(feat).to(device).contiguous()


def _index_tensor(a, device, name):
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    if t.numel() and int(t.max()) > INT32_MAX:
        raise ValueError(f"{name} exceeds int32; the kernels index with "
                         "int32")
    return t.to(device=device, dtype=torch.int32).contiguous()


class ServeEngine:
    """A fanout-variant set over one model (any module with
    ``forward(x, adjs, generator=None)``: ``GraphSAGE``, ``GAT``) and one
    feature tier.

    ``sizes_variants`` is the degradation ladder (index 0 full quality;
    every entry has the model's hop count). ``feat`` is a tensor or
    numpy array, a ``quant.QuantizedTensor``, or a ``Feature`` store on
    the engine's device, whose tiered lookup becomes the gather stage
    (the cold fixup on the fused route); ``params`` an optional
    state dict loaded into ``model`` (see ``models.convert`` for flax
    parameters). ``topo`` is a ``CSRTopo`` or an ``(indptr, indices)``
    pair. Everything moves to ``device``: the card unless the caller
    passes ``device="cpu"``; with no card and no such request the
    constructor raises. ``fused_hot_hop`` picks the route, fused walk or
    split path, and ``method`` the split path's sampler (see
    :func:`build_serve_step`). ``seed`` seeds the host
    generator the per-hop seeds come from. ``collect_metrics=True``
    puts each ``run``'s device counter vector on ``last_counters``
    (read it lazily, e.g. through ``metrics.StepStats``).

    ``run`` is not thread-safe (the generator is serial state): a
    ``MicroBatchServer`` calls it from its executor thread alone, and
    ``refresh_feature`` and ``warmup`` must not run while a server over
    the engine does.
    """

    def __init__(self, model, params, topo, feat,
                 sizes_variants: Sequence[Sequence[int]],
                 batch_cap: int, forder=None, method: str = "exact",
                 dedup_gather=None, collect_metrics: bool = False,
                 fused_hot_hop: bool = False, fused_row_cap: int = 2048,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card the tensors land on, named: the server's executor
            # thread enters it before each run
            self.device = torch.device("cuda", torch.cuda.current_device())
        if not sizes_variants:
            raise ValueError("need at least one fanout variant")
        hops = {len(s) for s in sizes_variants}
        if len(hops) != 1:
            raise ValueError(
                f"all fanout variants must share the model's hop count, "
                f"got lengths {sorted(hops)}")
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.variants: List[List[int]] = [list(s) for s in sizes_variants]
        self.batch_cap = int(batch_cap)
        self.method = method
        self.collect_metrics = bool(collect_metrics)
        self.last_counters = None
        self._store = None
        indptr, indices = (topo.indptr, topo.indices) \
            if hasattr(topo, "indptr") else topo
        self._indptr = _index_tensor(indptr, self.device, "indptr")
        self._indices = _index_tensor(indices, self.device, "indices")
        gather, hot_rows = None, None
        if hasattr(feat, "lookup_tiered"):           # a Feature store
            if feat.device.type != self.device.type:
                raise ValueError(f"the Feature store lives on "
                                 f"{feat.device}, the engine on "
                                 f"{self.device}")
            self._store = feat
            feat, forder, gather = _feature_gather(feat)
            if gather is not None:
                if feat[0] is None and fused_hot_hop:
                    raise ValueError("fused_hot_hop needs a store with a "
                                     "hot tier on the device")
                hot_rows = None if feat[0] is None \
                    else quant.tier_rows(feat[0])
            self._feat = feat
        else:
            self._feat = _to_device_tier(feat, self.device)
        self._forder = None if forder is None else \
            _index_tensor(forder, self.device, "forder")
        self._steps = [
            build_serve_step(self.model, sizes, self.batch_cap,
                             method=method, dedup_gather=dedup_gather,
                             gather=gather,
                             collect_metrics=self.collect_metrics,
                             fused_hot_hop=fused_hot_hop,
                             fused_row_cap=fused_row_cap,
                             fused_hot_rows=hot_rows)
            for sizes in self.variants]
        self._gen = torch.Generator().manual_seed(int(seed))

    @property
    def jitted_fns(self) -> tuple:
        """The compiled programs a ``StepStats.watch_compiles`` would
        watch: none, since the steps run eagerly and the kernels build
        once at first use (``warmup``)."""
        return ()

    def pad_seeds(self, node_ids) -> torch.Tensor:
        """Batch assembly: distinct valid ids first, -1 fill to
        ``[batch_cap]`` (the serve step's seed contract), on the
        engine's device."""
        ids = node_ids if torch.is_tensor(node_ids) else \
            torch.from_numpy(np.asarray(node_ids, np.int32))
        ids = ids.reshape(-1).to(device=self.device, dtype=torch.int32)
        if ids.shape[0] > self.batch_cap:
            raise ValueError(
                f"{ids.shape[0]} seeds exceed batch_cap={self.batch_cap}")
        if ids.shape[0] == self.batch_cap:
            return ids.contiguous()
        pad = torch.full((self.batch_cap - ids.shape[0],), -1,
                         dtype=torch.int32, device=self.device)
        return torch.cat([ids, pad])

    def draw_hop_seeds(self, hops: int) -> List[int]:
        """The next ``hops`` int32 kernel seeds from the host generator."""
        return draw_int32(self._gen, hops)

    def run(self, seeds, variant: int = 0,
            hop_seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Serve one seed block through the given variant. Returns the
        ``[batch_cap, out_dim]`` logits on the engine's device without
        synchronising. ``hop_seeds`` (one int32 per hop) replaces the
        generator's draw, e.g. to replay the JAX package's seeds. With
        ``collect_metrics`` the batch's counter vector lands on
        ``last_counters``."""
        sizes = self.variants[variant]
        if hop_seeds is None:
            hop_seeds = self.draw_hop_seeds(len(sizes))
        out = self._steps[variant](
            list(hop_seeds), self._feat, self._forder, self._indptr,
            self._indices, self.pad_seeds(seeds))
        if not self.collect_metrics:
            return out
        logits, self.last_counters = out
        return logits

    def refresh_feature(self) -> "ServeEngine":
        """Re-splice the ``Feature`` store's tiers into this engine after
        an online mutation (``Feature.rotate_hot_set``). The engine took
        the store's hot tier, its order and its own pinned copy of a
        host tier at construction, so until this call it serves the
        store as it was. The host tier is pinned (an int8 tier packed)
        anew from the store's; shapes and dtypes must not change, as in
        JAX, so the steps stay as built."""
        if self._store is None:
            raise ValueError(
                "refresh_feature needs an engine built over a Feature "
                "store (this one was built over a plain tensor)")
        feat, forder, _ = _feature_gather(self._store)
        if _tier_signature(feat) != _tier_signature(self._feat):
            raise ValueError(
                "refreshed feature tiers changed shape or dtype; refusing "
                "(the serve steps were built for the old ones)")
        self._feat = feat
        self._forder = None if forder is None else \
            _index_tensor(forder, self.device, "forder")
        return self

    def warmup(self) -> "ServeEngine":
        """One dispatch per variant, so the first real request pays no
        kernel build."""
        n = min(self.batch_cap, int(self._indptr.shape[0]) - 1)
        for v in range(len(self.variants)):
            self.run(torch.arange(n, dtype=torch.int32), v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self


# -- sharded serving: one partitioned store under the whole group -----------


def build_sharded_serve_step(model, sizes: Sequence[int], batch_cap: int,
                             group, rows_per_host: int,
                             method: str = "exact", exchange_cap=None,
                             home: Optional[int] = None,
                             collect_metrics: bool = False,
                             fused_hot_hop: bool = False,
                             fused_row_cap: int = 2048):
    """The serve step over a ``DistFeature``-partitioned store, one
    rank's part; every rank of ``group`` runs it together on the same
    seed block and hop seeds.

    Returns ``step(hop_seeds, feat, g2h, g2l, indptr, indices, seeds)``
    -> ``logits[batch_cap, out_dim]`` (and the group's
    ``[metrics.NUM_COUNTERS]`` vector with ``collect_metrics``, merged
    on the device by ``metrics.pmerge_counters``). ``feat`` is this
    rank's shard (``DistFeature.shard``), ``g2h``/``g2l`` the placement
    maps, the topology and the ``[batch_cap]`` seed block the same on
    every rank. Sampling runs on every rank alike: with
    ``fused_hot_hop=True`` (exact method) the CUDA sampling kernel on
    every hop (``ops.kernels.fused.fused_sample_multihop``, hop ``i``
    seeded with ``hop_seeds[i]``), otherwise ``method``'s sampler from a
    generator seeded with ``hop_seeds[0]``. So the frontier and the
    logits are the single-store step's over the unpartitioned table, bit
    for bit: only where the rows live changes. The rows then come
    through the exchange (``comm.dist_lookup_local``; ``exchange_cap``
    ``True | int | None``, True sized from the frontier's capacity) and
    the model runs in eval mode.

    ``home`` is this replica's partition: with ``collect_metrics`` every
    valid frontier row is classified once (on rank 0 only, so the merge
    does not multiply it), owned by ``home`` as ``LOCALITY_HIT_ROWS``,
    elsewhere as ``LOCALITY_MISS_ROWS``."""
    sizes = [int(k) for k in sizes]
    fused = _step_knobs(fused_hot_hop, fused_row_cap, sizes, method, None)
    h_count = axis_size(group)
    first = axis_index(group) == 0
    if exchange_cap is True:
        frontier = layer_shapes(batch_cap, sizes)[-1].n_id_cap
        exchange_cap = default_exchange_cap(frontier, h_count)
    elif exchange_cap is not None:
        exchange_cap = int(exchange_cap)

    @hot_path
    def step(hop_seeds, feat, g2h, g2l, indptr, indices, seeds):
        col = metrics.Collector(seeds.device) if collect_metrics else None
        # counters of the sampling every rank repeats: rank 0's only
        rep_col = metrics.Collector(seeds.device) if collect_metrics \
            else None
        with torch.inference_mode():
            if fused is not None:
                n_id, layers = fused_sample_multihop(
                    indptr, indices, seeds, sizes, hop_seeds,
                    fused["row_cap"])
                if rep_col is not None:
                    rep_col.add(metrics.FRONTIER_VALID,
                                (n_id >= 0).sum(dtype=torch.int32))
                    rep_col.add(metrics.FRONTIER_CAP, int(n_id.shape[0]))
            else:
                n_id, layers = sample_multihop_serving(
                    indptr, indices, seeds, sizes,
                    torch.Generator(device=seeds.device).manual_seed(
                        int(hop_seeds[0])),
                    method=method, collector=rep_col)
            x = dist_lookup_local(n_id, g2h, g2l, feat, group, h_count,
                                  rows_per_host, exchange_cap=exchange_cap,
                                  collector=col)
            adjs = layers_to_adjs(layers, batch_cap, sizes)
            logits = model(x, adjs)[:batch_cap]
            if col is None:
                return logits
            if home is not None:
                valid = n_id >= 0
                owner = g2h[n_id.long().clamp(min=0)]
                rep_col.add(metrics.LOCALITY_HIT_ROWS,
                            (valid & (owner == home)).sum(dtype=torch.int32))
                rep_col.add(metrics.LOCALITY_MISS_ROWS,
                            (valid & (owner != home)).sum(dtype=torch.int32))
            rep = rep_col.counters()
            col.absorb(rep if first else torch.zeros_like(rep))
            return logits, metrics.pmerge_counters(col.counters(), group)

    return step


class ShardedServeEngine:
    """A ``ServeEngine`` whose feature tier is one partitioned store
    shared by the group's ranks (a ``DistFeature`` built by
    ``from_partition``): each rank holds about ``1/P`` of the rows, and
    frontier rows owned elsewhere arrive through the exchange.

    Every rank of the group builds its engine with the same model,
    parameters, topology, ladder and ``seed``, and calls ``run`` with
    the same seed blocks in the same order: a run is collective, and
    each rank's host generator draws the same hop seeds. ``home`` names
    this replica's partition (default ``dist.info.host``; it scopes the
    locality counters and rides a ``MicroBatchServer``'s snapshot as
    its ``partition`` block, with ``partitions``). The exchange's knob
    is ``dist.exchange_cap``; with ``collect_metrics`` the counters are
    the group's merged vector. The logits are the single-store
    ``ServeEngine``'s over the unpartitioned table bit for bit (with
    ``fused_hot_hop=True`` on both, against the fused engine). A store
    with a replicated tail is refused, as in JAX. The engine lives on
    the store's device."""

    def __init__(self, model, params, topo, dist,
                 sizes_variants: Sequence[Sequence[int]], batch_cap: int,
                 method: str = "exact", home: Optional[int] = None,
                 collect_metrics: bool = False, fused_hot_hop: bool = False,
                 fused_row_cap: int = 2048, seed: int = 0):
        if not sizes_variants:
            raise ValueError("need at least one fanout variant")
        hops = {len(s) for s in sizes_variants}
        if len(hops) != 1:
            raise ValueError(
                f"all fanout variants must share the model's hop count, "
                f"got lengths {sorted(hops)}")
        if getattr(dist, "shard", None) is None:
            raise ValueError(
                "ShardedServeEngine needs a DistFeature built with "
                "from_partition (the process-group mode)")
        if getattr(dist, "_rep_args", None) is not None:
            raise ValueError(
                "ShardedServeEngine does not support replicated-tail "
                "stores yet; partition without replicate=")
        self.device = dist.device
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.dist = dist
        self.variants: List[List[int]] = [list(s) for s in sizes_variants]
        self.batch_cap = int(batch_cap)
        self.method = method
        self.home = int(dist.info.host if home is None else home)
        self.partitions = int(dist.info.hosts)
        self.collect_metrics = bool(collect_metrics)
        self.last_counters = None
        indptr, indices = (topo.indptr, topo.indices) \
            if hasattr(topo, "indptr") else topo
        self._indptr = _index_tensor(indptr, self.device, "indptr")
        self._indices = _index_tensor(indices, self.device, "indices")
        self._steps = [
            build_sharded_serve_step(
                self.model, sizes, self.batch_cap, dist.comm.group,
                dist._rows_per_host, method=method,
                exchange_cap=dist.exchange_cap, home=self.home,
                collect_metrics=self.collect_metrics,
                fused_hot_hop=fused_hot_hop, fused_row_cap=fused_row_cap)
            for sizes in self.variants]
        self._gen = torch.Generator().manual_seed(int(seed))

    jitted_fns = ServeEngine.jitted_fns
    pad_seeds = ServeEngine.pad_seeds
    draw_hop_seeds = ServeEngine.draw_hop_seeds

    def run(self, seeds, variant: int = 0,
            hop_seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Serve one seed block through the given variant (collective:
        see the class). Returns the ``[batch_cap, out_dim]`` logits on
        the engine's device; with ``collect_metrics`` the group's counter
        vector lands on ``last_counters``. ``hop_seeds`` replaces the
        generator's draw."""
        sizes = self.variants[variant]
        if hop_seeds is None:
            hop_seeds = self.draw_hop_seeds(len(sizes))
        out = self._steps[variant](
            list(hop_seeds), self.dist.shard, self.dist._g2h,
            self.dist._g2l, self._indptr, self._indices,
            self.pad_seeds(seeds))
        if not self.collect_metrics:
            return out
        logits, self.last_counters = out
        return logits

    def warmup(self) -> "ShardedServeEngine":
        """One dispatch per variant (collective, like ``run``)."""
        return ServeEngine.warmup(self)


# -- the request path: admission, coalescing, shedding, scatter --------------


class OverloadError(RuntimeError):
    """Raised by ``MicroBatchServer.submit`` when the admission queue is
    full — the load-shedding half of overload handling: rejecting at
    admission is the only response that keeps the latency of the
    requests already admitted bounded. When raised from
    ``submit_many``, ``futures`` carries the futures of the requests
    that WERE admitted before the queue filled (they still run)."""

    futures: Sequence = ()


#: the built-in tenant SLO classes, highest priority first; shed order
#: is the REVERSE of this tuple (best_effort absorbs load- and
#: quality-shed first, interactive last)
TENANT_CLASS_NAMES = ("interactive", "batch", "best_effort")


class TenantClass:
    """One tenant SLO class — the unit of multi-tenant accounting and
    shed policy in :class:`MicroBatchServer`.

    - ``priority``: admission displacement order. A full queue evicts
      the newest queued request of the lowest priority STRICTLY below
      the arriving request's, never the reverse — so interactive
      admission consumes best-effort queue slots under overload.
    - ``admission_weight``: the class's guaranteed share of the
      admission queue. Under pressure (queue past the shed threshold)
      a class already holding its weighted share is rejected at the
      door while under-share classes still admit — a best-effort flood
      cannot starve interactive admission.
    - ``shed_grace``: how many quality-shed ladder steps this class's
      batches ignore. Grace 0 (best_effort) degrades at the first shed
      step; a grace at least the ladder depth (interactive's default)
      degrades only under a planned floor (``set_shed_floor``) —
      quality shed consumes best-effort first, interactive last.
    - ``slo_p99_ms`` (+ the ``slo_*`` shape knobs): arms a per-class
      ``metrics.SloBudget`` for burn accounting. The SERVER's
      aggregate budget still drives the shed trigger; the per-class
      budget is the accounting the ``tenant`` JSONL kind reports.
    """

    def __init__(self, name: str, priority: int,
                 admission_weight: float = 1.0, shed_grace: int = 0,
                 slo_p99_ms: Optional[float] = None,
                 slo_availability: float = 0.99,
                 slo_window_s: float = 300.0,
                 slo_short_window_s: float = 30.0):
        if not name:
            raise ValueError("tenant class needs a name")
        if not admission_weight > 0.0:
            raise ValueError(
                f"admission_weight must be > 0, got {admission_weight}")
        if shed_grace < 0:
            raise ValueError(f"shed_grace must be >= 0, got {shed_grace}")
        self.name = str(name)
        self.priority = int(priority)
        self.admission_weight = float(admission_weight)
        self.shed_grace = int(shed_grace)
        self.slo_p99_ms = (None if slo_p99_ms is None
                           else float(slo_p99_ms))
        self.slo_availability = float(slo_availability)
        self.slo_window_s = float(slo_window_s)
        self.slo_short_window_s = float(slo_short_window_s)

    def make_budget(self) -> Optional[metrics.SloBudget]:
        """A fresh per-class ``metrics.SloBudget`` (None when this
        class declares no latency target)."""
        if self.slo_p99_ms is None:
            return None
        return metrics.SloBudget(self.slo_p99_ms,
                                 availability=self.slo_availability,
                                 window_s=self.slo_window_s,
                                 short_window_s=self.slo_short_window_s)


def default_tenant_classes(slo_p99_ms: Optional[float] = None) -> dict:
    """The standard three-class registry (``TENANT_CLASS_NAMES``):
    interactive (priority 2, 4x admission weight, never quality-shed
    before the ladder is exhausted, SLO target ``slo_p99_ms``), batch
    (priority 1, 2x weight, one step of grace, 4x the latency target),
    best_effort (priority 0, weight 1, no grace, no latency target —
    it absorbs the shed). Pass the dict to
    ``MicroBatchServer(tenants=...)``."""
    return {
        "interactive": TenantClass(
            "interactive", priority=2, admission_weight=4.0,
            shed_grace=8, slo_p99_ms=slo_p99_ms),
        "batch": TenantClass(
            "batch", priority=1, admission_weight=2.0, shed_grace=1,
            slo_p99_ms=(4.0 * slo_p99_ms if slo_p99_ms is not None
                        else None)),
        "best_effort": TenantClass(
            "best_effort", priority=0, admission_weight=1.0,
            shed_grace=0),
    }


class _TenantState:
    """Per-class accounting the server keeps under ``_counts_lock``
    (except ``budget``, which locks itself)."""

    __slots__ = ("cls", "budget", "hist", "counts", "queued", "share")

    def __init__(self, cls: TenantClass, share: int):
        self.cls = cls
        self.budget = cls.make_budget()
        self.hist = metrics._Histogram()
        self.queued = 0
        self.share = share
        self.counts = {"requests": 0, "completed": 0, "rejected": 0,
                       "displaced": 0, "deadline_expired": 0,
                       "failed": 0}


def health_score(burn: Optional[float] = None, shed_frac: float = 0.0,
                 stale: bool = False,
                 age_s: Optional[float] = None) -> Tuple[float, dict]:
    """The per-replica health formula (0 worst .. 1 best) a fleet
    router routes and drains on — deterministic, so a score is arguable
    from its inputs (the reference's ``fleet.health_score``):

    - ``stale`` (the replica's sink stopped advancing): score 0. A
      silent replica is DOWN until proven otherwise.
    - ``burn`` (the worse of the replica's short/long SLO burn rates):
      burning at or below 1.0 is sustainable and free; past it the
      penalty grows linearly to 0.5 at burn 2.0.
    - ``shed_frac`` (current shed level / ladder depth): full-quality
      serving is free; serving the cheapest variant costs 0.5.

    Returns ``(score, components)`` — the components dict records each
    input and penalty so a record is self-explaining."""
    burn_pen = 0.5 * min(1.0, max(0.0, (burn or 0.0) - 1.0))
    shed_pen = 0.5 * min(1.0, max(0.0, float(shed_frac)))
    score = 0.0 if stale else max(0.0, 1.0 - burn_pen - shed_pen)
    components = {
        "stale": bool(stale),
        "burn": None if burn is None else round(float(burn), 4),
        "burn_penalty": round(burn_pen, 4),
        "shed_frac": round(float(shed_frac), 4),
        "shed_penalty": round(shed_pen, 4),
    }
    if age_s is not None:
        components["age_s"] = round(float(age_s), 3)
    return round(score, 4), components


class ServeConfig:
    """Knobs for :class:`MicroBatchServer` (all latency budgets in ms).

    - ``max_wait_ms``: coalescing deadline — how long the FIRST request
      of a batch may wait for company before the batch dispatches
      anyway. The lone-request worst case adds exactly this much.
    - ``queue_depth``: admission bound; a full queue sheds load
      (``submit`` raises :class:`OverloadError`).
    - ``slo_p99_ms``: per-request latency target. Setting it arms a
      ``metrics.SloBudget`` (target p99 at ``slo_availability`` over
      sliding windows); the server sheds QUALITY — dispatches escalate
      one step down the engine's fanout ladder — while the budget burns
      unsustainably (short-window burn rate above ``shed_burn_rate``
      AND long-window burn above 1.0), and recovers one step after
      ``calm_batches`` consecutive calm decisions (hysteresis). Failed
      and admission-rejected requests count against the budget too.
    - ``slo_availability`` / ``slo_window_s`` / ``slo_short_window_s``
      / ``shed_burn_rate``: the budget's shape — tolerated bad
      fraction is ``1 - slo_availability`` (default 0.99: a literal
      p99 target) over ``slo_window_s``, with the reactive burn rate
      measured over ``slo_short_window_s``.
    - ``shed_queue_frac``: queue fullness (0..1) that also triggers a
      quality-shed step — backlog is tomorrow's latency, so the server
      reacts before the SLO is already blown.
    - ``pipeline_depth``: in-flight batch bound (coalesce i+1 while i
      runs; more depth adds queueing latency, not throughput, past 2).
    """

    def __init__(self, max_wait_ms: float = 2.0, queue_depth: int = 256,
                 slo_p99_ms: Optional[float] = None,
                 slo_availability: float = 0.99,
                 slo_window_s: float = 300.0,
                 slo_short_window_s: float = 30.0,
                 shed_burn_rate: float = 1.0,
                 shed_queue_frac: float = 0.5,
                 calm_batches: int = 8,
                 pipeline_depth: int = 2):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if not 0.0 < shed_queue_frac <= 1.0:
            raise ValueError("shed_queue_frac must be in (0, 1]")
        self.max_wait_ms = float(max_wait_ms)
        self.queue_depth = int(queue_depth)
        self.slo_p99_ms = slo_p99_ms
        self.slo_availability = float(slo_availability)
        self.slo_window_s = float(slo_window_s)
        self.slo_short_window_s = float(slo_short_window_s)
        self.shed_burn_rate = float(shed_burn_rate)
        self.shed_queue_frac = float(shed_queue_frac)
        self.calm_batches = int(calm_batches)
        self.pipeline_depth = int(pipeline_depth)


def _fail_future(fut, exc) -> bool:
    """Claim-and-fail one request future, tolerating a future some
    OTHER path already resolved: ``submit``'s close-race handler and
    ``close()``'s queue drain can both reach the same queued request,
    and stdlib ``set_running_or_notify_cancel`` RAISES on a finished
    future, so the loser of that race treats it as "already handled".
    Returns True when THIS call failed the future."""
    try:
        claimed = fut.set_running_or_notify_cancel()
    except RuntimeError:
        return False                 # already resolved elsewhere
    if claimed:
        fut.set_exception(exc)
    return claimed


class _Request:
    __slots__ = ("node_id", "future", "t_enq", "trace_id", "deadline",
                 "tenant")

    def __init__(self, node_id: int, future, t_enq: float,
                 trace_id=None, deadline: Optional[float] = None,
                 tenant: Optional[str] = None):
        self.node_id = node_id
        self.future = future
        self.t_enq = t_enq
        self.trace_id = trace_id
        self.deadline = deadline
        self.tenant = tenant


def _executor_device(engine):
    """The card the engine serves on, entered by the executor thread
    around each run (a fresh thread's current device is card 0), or a
    null context for an engine on the CPU (or a duck-typed one)."""
    dev = getattr(engine, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _readback(logits) -> np.ndarray:
    """A batch's ``[batch_cap, out_dim]`` logits as a host array of its
    own: one device-to-host copy from the card (the batch's one host
    synchronisation), a copy on the CPU, where ``numpy()`` would share
    the tensor's memory. The futures of the batch get rows of this
    array, so no later batch can overwrite a row a client has not read
    yet."""
    if not torch.is_tensor(logits):
        return np.array(logits)
    host = logits.detach().cpu()
    if logits.device.type == "cpu":
        host = host.clone()
    return host.numpy()


class MicroBatchServer:
    """Request-coalescing micro-batch front end over a ``ServeEngine``.

    ``submit(node_id)`` -> ``Future`` whose result is that node's
    ``[out_dim]`` numpy logits row (duplicate node ids landing in the
    same coalesced batch share one seed slot and one device read). Life
    cycle: ``start()`` spins the coalescer (done by the constructor
    unless ``start=False`` — tests use the paused form to stage
    bursts), ``close()`` rejects new work, fails queued requests
    loudly, and shuts the pipeline down (idempotent; also a context
    manager). ``snapshot()`` returns the JSONL-ready ``serving`` record;
    ``emit(sink)`` writes it.

    The engine (``batch_cap``, ``variants``, ``run(seeds, variant)``,
    ``collect_metrics``, ``last_counters``, ``jitted_fns`` and, on a
    card, ``device``) is driven by the executor thread alone: build its
    kernels with ``warmup()`` before ``start()``, and never call its
    ``run``, ``warmup`` or ``refresh_feature`` while the server runs.
    ``hub`` (optional, duck-typed: ``observe(name, value)`` and
    ``observe_counters(vec)``) is fed per-batch series points on the
    executor thread.

    See :class:`ServeConfig` for the SLO/overload policy and the module
    docstring for the architecture."""

    def __init__(self, engine, config: Optional[ServeConfig] = None,
                 stats=None, start: bool = True, hub=None,
                 tenants: Optional[dict] = None):
        from .pipeline import Pipeline
        self.engine = engine
        self.config = config or ServeConfig()
        self.stats = stats if stats is not None else metrics.StepStats()
        self.stats.watch_compiles(*engine.jitted_fns)
        self.hub = hub
        self._report_name = f"serving@{id(self):x}"
        cfg = self.config
        # the SLO budget is the shed policy's latency signal (burn
        # rates, not raw p99 samples) AND the `slo` JSONL payload
        self.slo: Optional[metrics.SloBudget] = None
        if cfg.slo_p99_ms is not None:
            self.slo = metrics.SloBudget(
                cfg.slo_p99_ms, availability=cfg.slo_availability,
                window_s=cfg.slo_window_s,
                short_window_s=cfg.slo_short_window_s,
                shed_burn_rate=cfg.shed_burn_rate)
        # tenancy: OPTIONAL {name: TenantClass} registry. None disables
        # the whole plane; with a registry every request files under a
        # class (None tenant -> the lowest-priority class) and shed
        # ORDER becomes policy. It never changes the seed block.
        self._tenants: Optional[dict] = None
        self._tenant_default: Optional[str] = None
        self._tenant_states: dict = {}
        # requests popped by the coalescer but deferred to a later
        # batch (class-pure coalescing under a shed episode);
        # coalescer-thread-only, swept by close()/the death watchdog
        self._held: list = []
        if tenants:
            reg = dict(tenants)
            for n, c in reg.items():
                if not isinstance(c, TenantClass):
                    raise TypeError(
                        f"tenants[{n!r}] must be a TenantClass")
                if n != c.name:
                    raise ValueError(
                        f"tenant registry key {n!r} names a class "
                        f"called {c.name!r}")
            self._tenants = reg
            self._tenant_default = min(
                reg, key=lambda n: (reg[n].priority, n))
            wsum = sum(c.admission_weight for c in reg.values())
            for n, c in reg.items():
                share = max(1, int(np.ceil(
                    cfg.queue_depth * c.admission_weight / wsum)))
                self._tenant_states[n] = _TenantState(c, share)
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=cfg.queue_depth)
        self._pipe = Pipeline(depth=cfg.pipeline_depth,
                              name="quiver-serving-exec")
        self.stats.watch_pipeline(self._pipe)
        self._closed = False
        # broken = the coalescer thread died UNEXPECTEDLY (not close):
        # nothing will ever drain the queue again, so submissions fail
        # fast with ServerClosed instead of hanging on admission
        self._broken = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # shedding state (coalescer-thread only, except the counters)
        self._shed_level = 0
        self._calm = 0
        # the EFFECTIVE coalescing knobs, re-read by the coalescer per
        # batch so a swap lands on the next batch without a restart;
        # the seed block stays [engine.batch_cap] whatever the fill cap
        self._max_wait_s = cfg.max_wait_ms / 1e3
        self._fill_cap = engine.batch_cap
        self._shed_floor = 0
        self._counts = {
            "requests": 0, "rejected": 0, "completed": 0, "failed": 0,
            "deadline_expired": 0, "displaced": 0,
            "batches": 0, "coalesced": 0,
            "variant_batches": [0] * len(engine.variants),
        }
        self._counts_lock = threading.Lock()
        # register into metrics.report() LAST: a constructor that
        # raises above must not leak a broken section; the name is
        # unique so parallel servers coexist
        metrics.register_report_section(self._report_name, self.report)
        if start:
            self.start()

    # -- life cycle ---------------------------------------------------------
    def start(self) -> "MicroBatchServer":
        with self._lock:
            if self._closed or self._broken:
                raise ServerClosed("server is closed")
            if self._thread is None:
                t = threading.Thread(target=self._coalesce_guard,
                                     name="quiver-serving-coalescer",
                                     daemon=True)
                t.start()
                self._thread = t
        return self

    def close(self):
        """Reject new submissions, fail queued (never-dispatched)
        requests with ``ServerClosed`` (a ``RuntimeError``), drain the
        in-flight batches, stop the coalescer and the pipeline.
        Idempotent."""
        metrics.unregister_report_section(self._report_name)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t = self._thread
            self._thread = None
        if t is not None and t is not threading.current_thread():
            t.join()
        # the coalescer is gone: anything still queued or held will
        # never run
        undispatched = list(self._held)
        self._held = []
        while True:
            try:
                undispatched.append(self._q.get_nowait())
            except queue.Empty:
                break
        self._fail_batch(undispatched)
        # coalesced batches still QUEUED in the pipeline are cancelled
        # by its close; their done-callbacks (armed at submit) fail the
        # request futures — the running batch drains normally first
        self._pipe.close()

    def __enter__(self) -> "MicroBatchServer":
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- admission ----------------------------------------------------------
    def _account_shed(self, tenant: Optional[str], key: str) -> None:
        """File one shed outcome (admission ``rejected``,
        ``displaced``, or ``deadline_expired``) into the aggregate
        counters, the aggregate SLO budget, and the owning tenant's
        accounting."""
        if self.slo is not None:
            self.slo.record(ok=False)    # a shed request is a miss
        st = self._tenant_states.get(tenant) if tenant else None
        with self._counts_lock:
            self._counts[key] += 1
            if st is not None:
                st.counts[key] += 1
        if st is not None and st.budget is not None:
            st.budget.record(ok=False)

    def _displace_for(self, priority: int) -> bool:
        """Queue-discipline load shed: evict the NEWEST queued request
        of the lowest priority STRICTLY below ``priority`` to make
        room for a higher-priority admission (tenancy only). The
        victim's future fails with :class:`OverloadError` and its
        class absorbs the shed. Returns True when a slot was freed."""
        q = self._q
        with q.mutex:
            best_i, best_p = -1, priority
            for i in range(len(q.queue) - 1, -1, -1):
                p = self._tenants[q.queue[i].tenant].priority
                if p < best_p:
                    best_i, best_p = i, p
            if best_i < 0:
                return False
            victim = q.queue[best_i]
            del q.queue[best_i]
            q.not_full.notify()
        with self._counts_lock:
            self._tenant_states[victim.tenant].queued -= 1
        if _fail_future(victim.future, OverloadError(
                "displaced at admission by a higher-priority tenant")):
            self._account_shed(victim.tenant, "displaced")
        return True

    def submit(self, node_id: int, context=None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Admit one point query; returns a ``Future`` resolving to the
        node's logits row (numpy ``[out_dim]``). Raises
        :class:`OverloadError` IMMEDIATELY when the admission queue is
        full, and :class:`~quiver_tpu_torch.rpc.ServerClosed` when the
        server is closed OR its coalescer thread died (a request that
        nothing will ever drain must fail fast, never hang).

        ``deadline`` (absolute ``time.perf_counter()`` instant — the
        RPC front end converts its wire budget) arms per-request
        deadline shedding: a request whose deadline passes while it
        waits is failed with
        :class:`~quiver_tpu_torch.rpc.DeadlineExceeded` at coalesce
        time, BEFORE it wastes a seed slot.

        ``context`` is optional request metadata carrying a propagated
        trace context (``tracing.inject`` on the client side): when
        tracing is on, this request's spans record under the CLIENT's
        ``trace_id``. A missing or mangled context falls back to a
        local id — never an error.

        ``tenant`` names the request's :class:`TenantClass` when the
        server was built with a registry (``tenants=``); a ``None``
        tenant lands in the lowest-priority class and an unregistered
        name raises ``ValueError``. Without a registry the argument is
        accepted and ignored."""
        if self._closed or self._broken:
            raise ServerClosed("server is closed"
                               if self._closed else
                               "server is broken (coalescer died)")
        tname = None
        st = None
        if self._tenants is not None:
            tname = tenant if tenant is not None else \
                self._tenant_default
            st = self._tenant_states.get(tname)
            if st is None:
                raise ValueError(
                    f"unknown tenant class {tname!r} (registered: "
                    f"{sorted(self._tenants)})")
        fut: Future = Future()
        tid = None
        if tracing.enabled():
            ctx = tracing.extract(context) if context is not None \
                else None
            tid = ctx.trace_id if ctx is not None \
                else tracing.new_trace_id()
        req = _Request(int(node_id), fut, time.perf_counter(), tid,
                       deadline, tname)
        cfg = self.config
        if st is not None:
            # weighted admission shares, enforced only under pressure
            # (queue past the shed threshold): a class already holding
            # its share is rejected at the door while under-share
            # classes still admit; a calm queue never rejects
            shed_at = max(1, int(cfg.queue_depth * cfg.shed_queue_frac))
            if self._q.qsize() >= shed_at and st.queued >= st.share:
                self._account_shed(tname, "rejected")
                raise OverloadError(
                    f"admission queue pressed and tenant {tname!r} "
                    f"holds its share ({st.share}); request shed")
        try:
            self._q.put_nowait(req)
        except queue.Full:
            # tenancy: a full queue displaces the newest queued request
            # of a strictly lower priority before giving up (one retry;
            # a lost race with another submitter is an honest reject)
            admitted = False
            if st is not None and self._displace_for(st.cls.priority):
                try:
                    self._q.put_nowait(req)
                    admitted = True
                except queue.Full:
                    pass
            if not admitted:
                self._account_shed(tname, "rejected")
                raise OverloadError(
                    f"admission queue full ({cfg.queue_depth} "
                    "pending); request shed") from None
        if self._closed or self._broken:
            # close() (or the death watchdog) raced us: its drain may
            # have run before our put landed — reclaim the request so
            # its future cannot strand (the claim is exclusive)
            _fail_future(req.future, ServerClosed("server is closed"))
            raise ServerClosed("server is closed")
        with self._counts_lock:
            self._counts["requests"] += 1
            if st is not None:
                st.counts["requests"] += 1
                st.queued += 1
        return fut

    def submit_many(self, node_ids, context=None,
                    deadline: Optional[float] = None,
                    tenant: Optional[str] = None) -> list:
        """``submit`` per id (one shared ``context``). If admission
        overloads mid-list the raised :class:`OverloadError` carries
        the already-admitted futures on ``.futures`` — admitted work
        runs regardless, so its results must stay observable."""
        futs: list = []
        for i in node_ids:
            try:
                futs.append(self.submit(i, context=context,
                                        deadline=deadline,
                                        tenant=tenant))
            except OverloadError as e:
                e.futures = futs
                raise
        return futs

    # -- actuation knobs ----------------------------------------------------
    def set_max_wait_ms(self, ms: float) -> None:
        """Swap the effective coalescing deadline. Takes effect on the
        NEXT batch."""
        ms = float(ms)
        if not ms > 0.0:
            raise ValueError(f"max_wait_ms must be > 0, got {ms}")
        self._max_wait_s = ms / 1e3

    def set_batch_fill_cap(self, cap: Optional[int]) -> None:
        """Swap the effective coalescing FILL cap: batches stop
        coalescing at ``cap`` distinct seeds but still dispatch at the
        engine's ``[batch_cap]`` seed shape (-1 padded). ``None``
        restores the engine cap; a cap past ``batch_cap`` is refused."""
        if cap is None:
            self._fill_cap = self.engine.batch_cap
            return
        cap = int(cap)
        if not 1 <= cap <= self.engine.batch_cap:
            raise ValueError(
                f"batch fill cap must be in [1, "
                f"{self.engine.batch_cap}], got {cap}")
        self._fill_cap = cap

    def set_shed_floor(self, level: int) -> None:
        """Planned quality floor (a fleet's plan): dispatches never run
        a variant ABOVE quality ``level`` while the floor is raised —
        the local hysteresis still escalates further under local
        pressure. 0 restores full local autonomy."""
        level = int(level)
        top = len(self.engine.variants) - 1
        if not 0 <= level <= top:
            raise ValueError(
                f"shed floor must be in [0, {top}], got {level}")
        self._shed_floor = level

    def knobs(self) -> dict:
        """The effective actuation knobs."""
        return {"max_wait_ms": round(self._max_wait_s * 1e3, 6),
                "batch_fill_cap": self._fill_cap,
                "shed_floor": self._shed_floor}

    # -- coalescing ---------------------------------------------------------
    def _coalesce_guard(self):
        """The coalescer's thread-death watchdog: any exception
        escaping the loop (an injected ``serve.coalesce`` fault, a bug)
        marks the server BROKEN and fails every queued future with
        ``ServerClosed`` at once, then re-raises so the death stays
        visible."""
        try:
            self._coalesce_loop()
        except BaseException as e:
            if self._closed:
                raise
            self._broken = True
            _log.error("serving coalescer died unexpectedly (%s: %s); "
                       "failing queued requests with ServerClosed",
                       type(e).__name__, e)
            undispatched = list(self._held)
            self._held = []
            while True:
                try:
                    undispatched.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._fail_batch(undispatched,
                             "coalescer thread died; server is broken",
                             exc_type=ServerClosed)
            raise

    def _shed_expired(self, req) -> bool:
        """Fail ``req`` with DeadlineExceeded if its deadline already
        passed — BEFORE it costs a batch seed slot. Returns True when
        the request was shed (or already claimed elsewhere)."""
        if req.deadline is None or time.perf_counter() <= req.deadline:
            return False
        if _fail_future(req.future, DeadlineExceeded(
                "deadline passed while queued (shed at coalesce — the "
                "client has already given up on this request)")):
            self._account_shed(req.tenant, "deadline_expired")
            if tracing.enabled() and req.trace_id is not None:
                # the request's TERMINAL span, error-stamped
                now = time.perf_counter()
                tracing.record("serve.request", req.t_enq,
                               now - req.t_enq, req.trace_id,
                               {"node": req.node_id,
                                "error": "DeadlineExceeded"})
        return True

    def _note_popped(self, req) -> None:
        """Per-tenant queued-count bookkeeping for one admission-queue
        pop (weighted-share admission reads these counts)."""
        if self._tenants is not None:
            with self._counts_lock:
                self._tenant_states[req.tenant].queued -= 1

    def _pop_next(self, timeout: float):
        """Next request for the coalescer: deferred (held) requests
        first, oldest first, then the admission queue. Raises
        ``queue.Empty`` on timeout."""
        if self._held:
            return self._held.pop(0)
        req = self._q.get(timeout=timeout)
        self._note_popped(req)
        return req

    def _coalesce_loop(self):
        while not self._closed:
            faults.fire("serve.coalesce")
            # effective knobs re-read per batch: a swap lands on the
            # NEXT batch
            max_wait = self._max_wait_s
            cap = min(self._fill_cap, self.engine.batch_cap)
            try:
                first = self._pop_next(0.02)
            except queue.Empty:
                continue
            if self._shed_expired(first):
                continue
            # tenancy: under a shed episode batches coalesce CLASS-PURE
            # (the batch takes only the first request's class; others
            # defer to their own next batch), so the per-class
            # shed_grace variant applies per batch. Calm traffic
            # coalesces mixed: every class dispatches variant 0 there.
            bcls = None
            if self._tenants is not None and (
                    self._shed_level > 0 or self._shed_floor > 0):
                bcls = self._tenants[first.tenant]
            # span plumbing: one enabled-check per batch when tracing
            # is off; when on, each request gets admission_wait and
            # coalesce_wait spans carrying its trace_id + the batch id
            traced = tracing.enabled()
            bid = tracing.new_trace_id() if traced else None
            t_first = time.perf_counter()
            pops = [(first, t_first)]
            if traced:
                tracing.record("serve.admission_wait", first.t_enq,
                               t_first - first.t_enq, first.trace_id,
                               {"batch": bid, "node": first.node_id})
            batch = [first]
            slots = {first.node_id: 0}
            if bcls is not None and self._held:
                # sweep already-deferred requests of THIS class into
                # the batch up front (one pass — the rest stay held)
                keep = []
                for r in self._held:
                    if (len(slots) < cap
                            and self._tenants[r.tenant] is bcls):
                        if self._shed_expired(r):
                            continue
                        batch.append(r)
                        slots.setdefault(r.node_id, len(slots))
                        if traced:
                            t_pop = time.perf_counter()
                            pops.append((r, t_pop))
                            tracing.record(
                                "serve.admission_wait", r.t_enq,
                                t_pop - r.t_enq, r.trace_id,
                                {"batch": bid, "node": r.node_id})
                    else:
                        keep.append(r)
                self._held = keep
            deadline = t_first + max_wait
            # drain until the seed block is full or the first request's
            # wait budget is spent
            while len(slots) < cap:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    if bcls is None:
                        req = self._pop_next(remaining)
                    else:
                        # class-pure: pull from the queue only (held
                        # now holds only other classes)
                        req = self._q.get(timeout=remaining)
                        self._note_popped(req)
                except queue.Empty:
                    break
                if self._shed_expired(req):
                    continue
                if bcls is not None and \
                        self._tenants[req.tenant] is not bcls:
                    self._held.append(req)
                    continue
                batch.append(req)
                slots.setdefault(req.node_id, len(slots))
                if traced:
                    t_pop = time.perf_counter()
                    pops.append((req, t_pop))
                    tracing.record("serve.admission_wait", req.t_enq,
                                   t_pop - req.t_enq, req.trace_id,
                                   {"batch": bid, "node": req.node_id})
            # the seed block keeps the engine's width whatever the fill
            # cap
            seeds = np.full((self.engine.batch_cap,), -1, np.int32)
            for nid, s in slots.items():
                seeds[s] = nid
            variant = self._select_variant()
            if bcls is not None:
                # per-class quality-shed order: this class ignores
                # shed_grace ladder steps of the local shed level; the
                # planned floor still lower-bounds everyone
                top = len(self.engine.variants) - 1
                graced = max(0, min(self._shed_level, top)
                             - bcls.shed_grace)
                variant = max(graced, min(self._shed_floor, top))
            # the pipeline submit blocks at depth: backpressure from
            # the executor propagates here, the queue absorbs it, and a
            # full queue sheds at admission — bounded everywhere
            try:
                pf = self._pipe.submit(self._execute, batch, slots,
                                       seeds, variant, bid)
            except RuntimeError:
                if self._closed:       # close() raced the coalescer
                    self._fail_batch(batch)
                    return
                raise
            if traced:
                t_sub = time.perf_counter()
                tracing.record("serve.batch_coalesce", t_first,
                               t_sub - t_first, bid,
                               {"requests": len(batch),
                                "fill": len(slots), "variant": variant})
                for req, t_pop in pops:
                    tracing.record("serve.coalesce_wait", t_pop,
                                   t_sub - t_pop, req.trace_id,
                                   {"batch": bid})
            # a batch the pipeline cancels while queued (close() drains
            # it) never reaches _execute — fail its futures
            pf.add_done_callback(
                lambda f, b=batch:
                    self._fail_batch(b) if f.cancelled() else None)

    # -- shedding policy ----------------------------------------------------
    def _select_variant(self) -> int:
        """Quality-shed decision for the NEXT batch (coalescer thread
        only). Escalates one fanout step down the ladder when queue
        backlog crosses its threshold or the SLO error budget burns
        unsustainably (``SloBudget.should_shed``); recovers one step
        after ``calm_batches`` consecutive calm decisions (hysteresis,
        so the variant mix does not flap). A planned floor
        (``set_shed_floor``) lower-bounds the decision without
        disturbing the hysteresis state."""
        top = len(self.engine.variants) - 1
        if top == 0:
            return 0
        cfg = self.config
        shed_at = max(1, int(cfg.queue_depth * cfg.shed_queue_frac))
        # held (class-deferred) requests are backlog too
        pressed = self._q.qsize() + len(self._held) >= shed_at
        if not pressed and self.slo is not None:
            pressed = self.slo.should_shed()
        if pressed:
            self._shed_level = min(self._shed_level + 1, top)
            self._calm = 0
        elif self._shed_level:
            self._calm += 1
            if self._calm >= cfg.calm_batches:
                self._shed_level -= 1
                self._calm = 0
        return max(self._shed_level, min(self._shed_floor, top))

    # -- execution + scatter ------------------------------------------------
    def _fail_batch(self, batch, msg: str = "server closed before "
                                            "dispatch",
                    exc_type=ServerClosed):
        """Fail every not-yet-claimed future in ``batch`` with a TYPED
        error (``ServerClosed`` subclasses RuntimeError, so a retrying
        RPC client can route elsewhere while other callers still catch
        it). The claim is exclusive, so this composes race-free with
        ``_execute`` and caller-side ``cancel()``."""
        failed_reqs = []
        traced = tracing.enabled()
        now = time.perf_counter() if traced else 0.0
        for req in batch:
            if _fail_future(req.future, exc_type(msg)):
                failed_reqs.append(req)
                if traced and req.trace_id is not None:
                    tracing.record("serve.request", req.t_enq,
                                   now - req.t_enq, req.trace_id,
                                   {"node": req.node_id,
                                    "error": exc_type.__name__})
        self._account_failed(failed_reqs)

    def _account_failed(self, reqs) -> None:
        """File failed requests into the SLO budget, the counters and
        their tenants' accounting."""
        if not reqs:
            return
        if self.slo is not None:
            for _ in reqs:
                self.slo.record(ok=False)
        with self._counts_lock:
            self._counts["failed"] += len(reqs)
            for req in reqs:
                st = self._tenant_states.get(req.tenant)
                if st is not None:
                    st.counts["failed"] += 1
        for req in reqs:
            st = self._tenant_states.get(req.tenant)
            if st is not None and st.budget is not None:
                st.budget.record(ok=False)

    def _execute(self, batch, slots, seeds, variant, bid=None):
        # claim every request's future up front: a caller-side cancel()
        # that lands after this point loses the race cleanly
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        t0 = time.perf_counter()
        try:
            faults.fire("serve.execute")
            with _executor_device(self.engine), torch.inference_mode():
                rows = _readback(self.engine.run(seeds, variant))
        except BaseException as e:
            # the batch's requests all see the step's exception; the
            # pipeline records the failure and stays up for the next
            # batch (nothing is retried)
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            self._account_failed(batch)
            if tracing.enabled():
                # error-stamped terminal spans
                now = time.perf_counter()
                for req in batch:
                    if req.trace_id is not None:
                        tracing.record("serve.request", req.t_enq,
                                       now - req.t_enq, req.trace_id,
                                       {"batch": bid,
                                        "node": req.node_id,
                                        "error": type(e).__name__})
            raise
        done = time.perf_counter()
        traced = tracing.enabled() and bid is not None
        if traced:
            tracing.record("serve.dispatch", t0, done - t0, bid,
                           {"variant": variant, "fill": len(slots),
                            "requests": len(batch)})
        counters = (self.engine.last_counters
                    if self.engine.collect_metrics else None)
        # the counter vector is folded lazily: no host sync here
        self.stats.record_step(done - t0, counters)
        if self.hub is not None:
            self.hub.observe("serve_batch_fill", len(slots))
            self.hub.observe("serve_batch_ms", 1e3 * (done - t0))
            self.hub.observe("serve_shed_level", variant)
            if counters is not None:
                self.hub.observe_counters(counters)
        # stats and counts land BEFORE the futures resolve: a client
        # woken by result() may snapshot() at once and must see its
        # own batch counted
        for req in batch:
            lat = done - req.t_enq
            self.stats.record_request(lat)
            if self.slo is not None:
                self.slo.record(lat)
            if self._tenants is not None:
                st = self._tenant_states.get(req.tenant)
                if st is not None and st.budget is not None:
                    st.budget.record(lat)
        with self._counts_lock:
            self._counts["completed"] += len(batch)
            self._counts["batches"] += 1
            self._counts["coalesced"] += len(batch)
            self._counts["variant_batches"][variant] += 1
            if self._tenants is not None:
                for req in batch:
                    st = self._tenant_states.get(req.tenant)
                    if st is not None:
                        st.counts["completed"] += 1
                        st.hist.add(done - req.t_enq)
        for req in batch:
            req.future.set_result(rows[slots[req.node_id]])
        if traced:
            t_end = time.perf_counter()
            # scatter = stats filing + future resolution
            tracing.record("serve.scatter", done, t_end - done, bid,
                           {"requests": len(batch)})
            for req in batch:
                tracing.record("serve.request", req.t_enq,
                               t_end - req.t_enq, req.trace_id,
                               {"batch": bid, "node": req.node_id,
                                "variant": variant})

    # -- observability ------------------------------------------------------
    def health(self) -> dict:
        """This replica's own health verdict (:func:`health_score` over
        the SLO burn rate and the shed level; a live server is never
        stale to itself). Returns ``{"score", "components"}``."""
        if self._broken:
            # a dead coalescer serves nothing
            return {"score": 0.0, "components": {"broken": True}}
        burn = None
        if self.slo is not None:
            s = self.slo.burn_rate(self.slo.short_window_s)
            l = self.slo.burn_rate(self.slo.window_s)
            rates = [r for r in (s, l) if r is not None]
            burn = max(rates) if rates else None
        top = max(len(self.engine.variants) - 1, 1)
        score, components = health_score(
            burn=burn, shed_frac=self._shed_level / top)
        return {"score": score, "components": components}

    def snapshot(self) -> dict:
        """One JSONL-ready record (kind ``serving``): the underlying
        ``StepStats`` snapshot (per-request AND per-batch latency
        percentiles, device counters, pipeline queue) plus the
        serving-layer facts — admission/shed counts, batch fill,
        per-variant batch mix, current shed level, health, knobs — and,
        when an SLO is configured, the ``SloBudget`` block."""
        rec = self.stats.snapshot()
        if self.slo is not None:
            rec["slo"] = self.slo.snapshot()
        with self._counts_lock:
            c = dict(self._counts)
            c["variant_batches"] = list(c["variant_batches"])
        b = c.pop("batches")
        coalesced = c.pop("coalesced")
        rec["serving"] = {
            **c,
            "batches": b,
            "mean_batch_fill": coalesced / b if b else 0.0,
            "queue_depth": self._q.qsize(),
            "shed_level": self._shed_level,
            "fanout_variants": [list(v) for v in self.engine.variants],
            "health": self.health()["score"],
            "knobs": self.knobs(),
        }
        home = getattr(self.engine, "home", None)
        if home is not None:
            # a sharded engine: this replica's partition, the fleet
            # plane's routing and locality pivot
            rec["serving"]["partition"] = {
                "home": int(home),
                "partitions": int(getattr(self.engine, "partitions", 1)),
            }
        return rec

    def emit(self, sink, kind: str = "serving") -> dict:
        """Append :meth:`snapshot` to a ``metrics.MetricsSink``."""
        return sink.emit(self.snapshot(), kind=kind)

    def tenant_snapshots(self) -> list:
        """One JSONL-ready record per registered tenant class (kind
        ``tenant``): the class declaration, the admission/outcome
        counters, the derived ``shed`` total (rejected + displaced +
        deadline-expired), the per-tenant latency histogram summary,
        and — when the class declares an SLO — its ``SloBudget``
        block. Empty list without a registry."""
        if self._tenants is None:
            return []
        recs = []
        with self._counts_lock:
            frozen = [(name, dict(st.counts), st.queued,
                       st.hist.n, st.hist.total, st.hist.max,
                       st.hist.quantile(0.5), st.hist.quantile(0.99))
                      for name, st in sorted(self._tenant_states.items())]
        for (name, c, queued, n, total, mx, p50, p99) in frozen:
            st = self._tenant_states[name]
            cls = st.cls
            rec = {
                "tenant": name,
                "priority": cls.priority,
                "admission_weight": cls.admission_weight,
                "shed_grace": cls.shed_grace,
                "queued": queued,
                "shed": (c["rejected"] + c["displaced"]
                         + c["deadline_expired"]),
                **c,
                "latency": {
                    "n": n,
                    "mean_ms": 1e3 * total / n if n else None,
                    "p50_ms": 1e3 * p50 if n else None,
                    "p99_ms": 1e3 * p99 if n else None,
                    "max_ms": 1e3 * mx if n else None,
                },
            }
            if st.budget is not None:
                rec["slo"] = st.budget.snapshot()
            recs.append(rec)
        return recs

    def emit_tenants(self, sink) -> list:
        """Append one record per registered class to a
        ``metrics.MetricsSink`` as kind ``tenant``."""
        recs = self.tenant_snapshots()
        for rec in recs:
            sink.emit(rec, kind="tenant")
        return recs

    def report(self) -> str:
        """Human-readable one-stop summary."""
        s = self.snapshot()
        sv = s["serving"]
        lines = [self.stats.report()]
        lines.append(
            f"serving: {sv['requests']} requests "
            f"({sv['rejected']} shed at admission, {sv['failed']} "
            f"failed), {sv['batches']} batches, mean fill "
            f"{sv['mean_batch_fill']:.1f}/{self.engine.batch_cap}, "
            f"variant mix {sv['variant_batches']}, shed level "
            f"{sv['shed_level']}")
        if "slo" in s:
            sl = s["slo"]
            short = sl["windows"]["short"]["burn_rate"]
            long_ = sl["windows"]["long"]["burn_rate"]
            rem = sl["budget_remaining"]
            fmt = lambda v: "n/a" if v is None else f"{v:.2f}"
            lines.append(
                f"slo: p99 target {sl['target_p99_ms']:.1f} ms at "
                f"{100.0 * sl['availability']:.1f}% — burn rate "
                f"{fmt(short)} (short) / {fmt(long_)} (long), "
                f"budget remaining "
                f"{'n/a' if rem is None else f'{100.0 * rem:.1f}%'}"
                f"{', SHEDDING' if sl['shedding'] else ''}")
        for t in self.tenant_snapshots():
            p99 = t["latency"]["p99_ms"]
            lines.append(
                f"tenant {t['tenant']}: {t['requests']} requests, "
                f"{t['completed']} completed, {t['shed']} shed "
                f"({t['rejected']} rejected, {t['displaced']} "
                f"displaced, {t['deadline_expired']} expired), p99 "
                f"{'n/a' if p99 is None else f'{p99:.1f} ms'}")
        return "\n".join(lines)
