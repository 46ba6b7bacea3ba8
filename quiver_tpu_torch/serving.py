"""Point-query GNN serving (counterpart of the serve step and
``ServeEngine`` of ``quiver_tpu/serving.py``).

Two routes. ``fused_hot_hop=True`` serves through the fused frontier
walk: interior hops run the CUDA sampling kernel, the leaf hop samples
and gathers the hot-tier rows (int8 dequant included) in one kernel.
``fused_hot_hop=False`` is the split path: the sampler of ``method``
(``ops.sample_multihop``: exact, or rotation and window, which permute
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
``MicroBatchServer`` is a later item of ROADMAP Queue 1 (item 1,
*MicroBatchServer*).

The JAX step threads a JAX random key and derives each hop's kernel
seed from it on the device. Here each hop's int32 seed is explicit:
``ServeEngine`` draws them on the host from its own ``torch.Generator``
(no device synchronisation), and ``run(seeds, hop_seeds=...)`` takes
them from the caller. The split path seeds its sampler's generator with
``hop_seeds[0]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import metrics
from .ops import quant
from .ops.sample_multihop import sample_multihop
from .parallel.train import (_dedup_gather_fn, _step_knobs, _walk,
                             draw_int32, layers_to_adjs)
from .utils.csr import INT32_MAX
from .utils.device import resolve_device
from .utils.placement import pinned_put


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

    def step(hop_seeds, feat, forder, indptr, indices, seeds):
        col = metrics.Collector(seeds.device) if collect_metrics else None
        with torch.inference_mode():
            if fused is None:
                x, layers = _walk(None, feat, forder, indptr, indices,
                                  seeds, sizes, hop_seeds, gather=gather,
                                  collector=col, method=method)
            else:
                hot = feat[0] if gather is not None else feat
                x, layers = _walk(fused, hot, forder, indptr, indices,
                                  seeds, sizes, hop_seeds,
                                  hot_rows=fused_hot_rows, collector=col)
                if gather is not None:
                    x = _cold_fixup(gather, feat, forder, layers[-1].n_id,
                                    x, fused_hot_rows, col)
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
    place) never reaches an engine that has not refreshed."""
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
    if feat is None or torch.is_tensor(feat):
        return None if feat is None else (tuple(feat.shape), feat.dtype)
    return [_tier_signature(t) for t in feat]


def _to_device_tier(feat, device):
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

    ``run`` is not thread-safe (the generator is serial state).
    """

    def __init__(self, model, params, topo, feat,
                 sizes_variants: Sequence[Sequence[int]],
                 batch_cap: int, forder=None, method: str = "exact",
                 dedup_gather=None, collect_metrics: bool = False,
                 fused_hot_hop: bool = False, fused_row_cap: int = 2048,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
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
