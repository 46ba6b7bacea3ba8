"""Point-query GNN serving (counterpart of the serve step and
``ServeEngine`` of ``quiver_tpu/serving.py``).

Two routes. ``fused_hot_hop=True`` serves through the fused frontier
walk: interior hops run the CUDA sampling kernel, the leaf hop samples
and gathers the hot-tier rows (int8 dequant included) in one kernel.
``fused_hot_hop=False`` is the split path: the exact i.i.d. sampler
(``ops.sample_multihop``) on every hop, then the masked row gather.
GraphSAGE runs on the assembled block either way. ``dedup_gather``, a
tiered ``Feature`` store, ``collect_metrics`` and ``MicroBatchServer``
are later items of ROADMAP Queue 1; asking for them raises
``NotImplementedError``.

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

from .ops import quant
from .ops.sample_multihop import sample_multihop
from .parallel.train import (_DEDUP, _METRICS, _step_knobs, _walk,
                             draw_int32, layers_to_adjs)
from .utils.csr import INT32_MAX
from .utils.device import resolve_device

_STORE = "ROADMAP Queue 1 'serve: Feature store with cold-tier fixup'"


def build_serve_step(model, sizes: Sequence[int], batch_cap: int,
                     method: str = "exact", dedup_gather=None,
                     gather=None, collect_metrics: bool = False,
                     fused_hot_hop: bool = False,
                     fused_row_cap: int = 2048,
                     fused_hot_rows: Optional[int] = None):
    """Point-inference step for one fanout config.

    Returns ``step(hop_seeds, feat, forder, indptr, indices, seeds)`` ->
    logits ``[batch_cap, out_dim]``. ``seeds`` is ``[batch_cap]`` int32,
    distinct valid ids first, -1 fill at the tail; rows of padded slots
    are garbage. ``hop_seeds`` holds one int32 kernel seed per hop.
    ``model`` is a ``GraphSAGE`` in eval mode on the data's device.
    ``fused_hot_hop=True`` walks through the fused kernels, hop ``i``
    seeded with ``hop_seeds[i]``; ``fused_hot_hop=False`` samples every
    hop exactly from one generator seeded with ``hop_seeds[0]``."""
    sizes = [int(k) for k in sizes]
    if gather is not None:
        raise NotImplementedError(_STORE)
    fused = _step_knobs(fused_hot_hop, fused_row_cap, sizes, method,
                        dedup_gather, collect_metrics)

    def step(hop_seeds, feat, forder, indptr, indices, seeds):
        with torch.inference_mode():
            x, layers = _walk(fused, feat, forder, indptr, indices, seeds,
                              sizes, hop_seeds, hot_rows=fused_hot_rows)
            adjs = layers_to_adjs(layers, batch_cap, sizes)
            return model(x, adjs)[:batch_cap]

    return step


def sample_multihop_serving(indptr, indices, seeds, sizes, generator,
                            method="exact", collector=None):
    """The split path's sampling stage: ``ops.sample_multihop`` under
    the serve step's batch contract (distinct valid seeds first, -1 tail
    fill, so ``seeds_dense``), every hop drawing from ``generator``."""
    return sample_multihop(indptr, indices, seeds, sizes, generator,
                           method=method, seeds_dense=True,
                           collector=collector)


def _to_device_tier(feat, device):
    if hasattr(feat, "lookup_tiered"):
        raise NotImplementedError(_STORE)
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
    """A fanout-variant set over one model and one feature tier.

    ``sizes_variants`` is the degradation ladder (index 0 full quality;
    every entry has the model's hop count). ``feat`` is a tensor or
    numpy array, or a ``quant.QuantizedTensor``; ``params`` an optional
    state dict loaded into ``model`` (see ``models.convert`` for flax
    parameters). ``topo`` is a ``CSRTopo`` or an ``(indptr, indices)``
    pair. Everything moves to ``device``: the card unless the caller
    passes ``device="cpu"``; with no card and no such request the
    constructor raises. ``fused_hot_hop`` picks the route, fused walk or
    split path (see :func:`build_serve_step`). ``seed`` seeds the host
    generator the per-hop seeds come from.

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
        if dedup_gather is not None:
            raise NotImplementedError(_DEDUP)
        if collect_metrics:
            raise NotImplementedError(_METRICS)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.variants: List[List[int]] = [list(s) for s in sizes_variants]
        self.batch_cap = int(batch_cap)
        self.method = method
        indptr, indices = (topo.indptr, topo.indices) \
            if hasattr(topo, "indptr") else topo
        self._indptr = _index_tensor(indptr, self.device, "indptr")
        self._indices = _index_tensor(indices, self.device, "indices")
        self._feat = _to_device_tier(feat, self.device)
        self._forder = None if forder is None else \
            _index_tensor(forder, self.device, "forder")
        self._steps = [
            build_serve_step(self.model, sizes, self.batch_cap,
                             method=method, fused_hot_hop=fused_hot_hop,
                             fused_row_cap=fused_row_cap)
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
        generator's draw, e.g. to replay the JAX package's seeds."""
        sizes = self.variants[variant]
        if hop_seeds is None:
            hop_seeds = self.draw_hop_seeds(len(sizes))
        return self._steps[variant](
            list(hop_seeds), self._feat, self._forder, self._indptr,
            self._indices, self.pad_seeds(seeds))

    def warmup(self) -> "ServeEngine":
        """One dispatch per variant, so the first real request pays no
        kernel build."""
        n = min(self.batch_cap, int(self._indptr.shape[0]) - 1)
        for v in range(len(self.variants)):
            self.run(torch.arange(n, dtype=torch.int32), v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
