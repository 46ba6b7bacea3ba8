"""PyG-style k-hop neighbour sampling (counterpart of
``quiver_tpu/pyg/sage_sampler.py``).

``GraphSageSampler(topo, sizes).sample(seeds)`` returns ``(n_id,
batch_size, adjs)`` like PyG's ``NeighborSampler``: static shapes (a
capacity and -1 fill; ``Adj.size`` gives the capacities, ``Adj.mask``
the valid edges), the adjs outermost hop first. Modes:

- ``"HBM"`` (alias ``"GPU"``): the topology on the card;
- ``"HOST"`` (alias ``"UVA"``, the reference's zero-copy mode): the
  topology, its rows views and edge-id maps in pinned host memory, read
  by the card's gathers (``ops/kernels/gather.py``) through
  ``ops.sample.take``. It runs the same tensor ops on the same draws as
  HBM mode, so for the same seed both give the same picks.

Sampling methods: ``"exact"`` (i.i.d. subsets; ``wide_exact`` reads
them through a rows view, the same draw), ``"rotation"`` and
``"window"`` over a row order that ``reshuffle()`` refreshes per epoch
(``shuffle="sort"`` or ``"butterfly"``; ``layout="pair"`` or
``"overlap"``). ``edge_weight`` (CSR-slot-aligned) makes every hop a
weighted draw (``ops/weighted.py``): the pool draw under ``"exact"``,
the windowed weighted draw over the co-shuffled weights' rows view
under ``"rotation"`` and ``"window"``; the weights lie where the
topology does. Random numbers come from one ``torch.Generator`` on the
sampler's device, seeded from ``seed``, where the JAX sampler keeps a
key chain.

``collect_metrics=True`` keeps each ``sample()``'s device counter vector
(``metrics.py``: the final frontier's valid slots and capacity) on
``last_counters``, counted on the card without a host synchronisation.
``mode="CPU"`` and ``MixedGraphSageSampler`` wait for the native CPU
engine (ROADMAP Queue 1 item 5) and raise ``NotImplementedError``
naming it.
"""

from __future__ import annotations

from typing import Generic, List, NamedTuple, Optional, Sequence, TypeVar

import numpy as np
import torch

from ..ops.sample import (as_index_rows, as_index_rows_overlapping,
                          compact_layer, compose_slot_map, edge_row_ids,
                          reshuffle_csr, sample_layer, sample_prob)
from .. import metrics
from ..ops.sample_multihop import sample_multihop
from ..utils.device import resolve_device
from ..utils.placement import pinned_put

_ENGINE = "ROADMAP Queue 1 item 5 (the native CPU engine)"
_WINDOWED = ("rotation", "window")
T_co = TypeVar("T_co", covariant=True)


class Adj:
    """One message-passing hop, PyG orientation (source -> target).

    edge_index: [2, cap_edges] int32, -1 fill; row 0 = source
                (neighbour) local id, row 1 = target (seed) local id.
    e_id:       [cap_edges] global edge ids when tracked, else None.
    size:       (cap_source_nodes, cap_target_nodes) static capacities.
    mask:       [cap_edges] bool validity of each edge slot.

    Destructures like PyG's: ``edge_index, e_id, size = adj``.
    """

    __slots__ = ("edge_index", "e_id", "size", "mask")

    def __init__(self, edge_index: torch.Tensor,
                 e_id: Optional[torch.Tensor], size,
                 mask: Optional[torch.Tensor] = None):
        self.edge_index = edge_index
        self.e_id = e_id
        self.size = tuple(size)
        self.mask = mask if mask is not None else edge_index[0] >= 0

    def __iter__(self):
        return iter((self.edge_index, self.e_id, self.size))

    def to(self, device, non_blocking: bool = False) -> "Adj":
        """The hop on ``device``: ``edge_index``, ``e_id`` and ``mask``
        moved (PyG's ``adj.to(device)``)."""
        def mv(t):
            return None if t is None else t.to(device,
                                              non_blocking=non_blocking)
        return Adj(mv(self.edge_index), mv(self.e_id), self.size,
                   mv(self.mask))


class _LayerShape(NamedTuple):
    num_seeds: int
    fanout: int
    n_id_cap: int


def layer_shapes(batch_size: int, sizes: Sequence[int]) -> List[_LayerShape]:
    """Each hop's static seed count, fanout and frontier capacity
    ``s * (1 + k)``."""
    shapes = []
    s = batch_size
    for k in sizes:
        cap = s + s * k
        shapes.append(_LayerShape(num_seeds=s, fanout=k, n_id_cap=cap))
        s = cap
    return shapes


class GraphSageSampler:
    """k-hop sampler returning ``(n_id, batch_size, adjs)`` like PyG's
    ``NeighborSampler`` (the reference's ``GraphSageSampler``). The
    arguments are the JAX sampler's, with ``device`` a torch device
    (``None``: the card). ``allow_fallback`` is kept in the signature
    and the IPC handle; pinning cannot fall back here
    (``utils/placement.py``)."""

    def __init__(self, csr_topo, sizes: Sequence[int], device=None,
                 mode: str = "HBM", seed: int = 0, edge_weight=None,
                 sampling: str = "exact", with_eid: bool = False,
                 layout: str = "pair", shuffle: str = "sort",
                 allow_fallback: bool = True, wide_exact: bool = True,
                 collect_metrics: bool = False):
        if mode not in ("HBM", "HOST", "CPU", "UVA", "GPU"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        # the reference's mode names: UVA -> HOST, GPU -> HBM
        mode = {"UVA": "HOST", "GPU": "HBM"}.get(mode, mode)
        if edge_weight is not None:
            e = int(csr_topo.edge_count)
            got = int(np.shape(edge_weight)[0])
            if got != e:
                raise ValueError(
                    f"edge_weight has {got} entries but the topology "
                    f"has {e} edges (weights are CSR-slot-aligned; use "
                    "ops.csr_weights_from_eid for COO-ordered weights)")
        if sampling not in ("exact",) + _WINDOWED:
            raise ValueError(f"unknown sampling method {sampling!r}")
        if sampling in _WINDOWED and mode == "CPU":
            sampling = "exact"   # the CPU engine has its own sampler
        if sampling in _WINDOWED and max(sizes, default=0) > 128:
            raise ValueError(f"{sampling} sampling supports fanouts <= 128")
        if layout not in ("pair", "overlap"):
            raise ValueError(f"unknown rotation layout {layout!r}")
        if shuffle not in ("sort", "butterfly"):
            raise ValueError(f"unknown shuffle {shuffle!r}")
        if shuffle == "butterfly" and edge_weight is not None and \
                sampling in _WINDOWED:
            # the weighted windowed draw anchors at the segment start and
            # needs the reshuffle to re-place hub neighbours uniformly;
            # butterfly moves an element at most 255 positions an epoch
            raise ValueError(
                "shuffle='butterfly' cannot provide the weighted "
                "windowed draw's mandatory hub re-placement (bounded "
                "per-epoch displacement; it anchors at the segment "
                "start) — use shuffle='sort' for weighted "
                "rotation/window")
        if mode == "CPU":
            raise NotImplementedError(f"mode='CPU': {_ENGINE}")
        self.mode = mode
        self.sizes = [int(k) for k in sizes]
        self.csr_topo = csr_topo
        self.device = resolve_device(device)
        self.edge_weight = edge_weight
        self.sampling = sampling
        self.with_eid = with_eid
        self.layout = layout
        self.shuffle = shuffle
        self.allow_fallback = allow_fallback
        self.collect_metrics = bool(collect_metrics)
        self.last_counters = None
        # wide_exact: exact mode reads through a rows view of the
        # indices, +E (pair) or +2E (overlap) in the topology's tier;
        # False keeps the scattered draw with no extra copy
        self.wide_exact = wide_exact
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(seed)
        self._placed = None       # (indptr, indices) where sampling reads
        self._weight_placed = None  # the edge weights, fp32, placed
        self._exact_rows = None   # un-shuffled rows view (wide exact)
        self._eid = None          # the topology's eid map, placed
        self._rot = None          # shuffled rows view (pair or overlap)
        self._rot_w = None        # co-shuffled weights' rows view
        self._rot_eid = None      # slot -> edge-id map, shuffled order
        self._permuted = None     # flat shuffled indices (butterfly state)
        self._permuted_w = None   # flat co-shuffled weights (butterfly)
        self._row_ids = None      # CSR row of every slot (HBM mode)

    # -- placement ------------------------------------------------------------
    def _put(self, t, what: str):
        """``t`` where the sampler reads it: the card (HBM), or pinned
        host memory (HOST; plain host memory for the CPU)."""
        if self.mode == "HOST":
            return pinned_put(t, self.device, what)
        return torch.as_tensor(t).to(self.device)

    def _refill(self, buf, t, what: str):
        """``t`` placed, reusing ``buf`` (a HOST-mode pinned buffer of the
        previous epoch) when it has the shape: pinned once, not every
        epoch."""
        if self.mode != "HOST":
            return t
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            return pinned_put(t, self.device, what)
        return buf.copy_(t)

    def lazy_init_quiver(self):
        if self._placed is None:
            self._placed = (self._put(self.csr_topo.indptr, "the indptr"),
                            self._put(self.csr_topo.indices, "the indices"))

    def _ensure_weights_placed(self):
        """The edge weights as fp32 where the topology lies, placed once
        (pinned host memory in HOST mode): the draw computes in fp32, so
        the cast loses nothing it would keep."""
        if self._weight_placed is None:
            w = torch.as_tensor(self.edge_weight, dtype=torch.float32)
            self._weight_placed = self._put(w.contiguous(),
                                            "the edge weights")
        return self._weight_placed

    @staticmethod
    def _rows_np(flat: np.ndarray, width: int = 128,
                 overlap: bool = False) -> np.ndarray:
        """numpy twin of ``ops.sample.as_index_rows(_overlapping)``, the
        same layout formulas, built in host memory without touching the
        card (HOST mode: the E- or 2E-sized view never goes there)."""
        e = flat.shape[0]
        nrows = (e + 2 * width - 1) // width + 1
        base = np.concatenate([flat, np.zeros(nrows * width - e,
                                              flat.dtype)]) \
            .reshape(nrows, width)
        if not overlap:
            return base
        nxt = np.concatenate([base[1:], np.zeros_like(base[:1])])
        return np.concatenate([base, nxt], axis=1)

    def _ensure_exact_rows(self):
        """The rows view (pair or overlap, by ``layout``) of the placed,
        un-shuffled indices: the wide-exact path's input, built once. HOST
        mode builds it in host memory (numpy) and pins it: the E- or
        2E-sized view never goes to the card."""
        if self._exact_rows is None:
            overlap = self.layout == "overlap"
            indices = self._placed[1]
            if self.mode == "HOST":
                self._exact_rows = pinned_put(
                    self._rows_np(indices.numpy(), overlap=overlap),
                    self.device, "the exact rows view")
            else:
                self._exact_rows = (as_index_rows_overlapping if overlap
                                    else as_index_rows)(indices)
        return self._exact_rows

    def _eid_map(self):
        """``True`` (stamp CSR slots) without a topology eid map, else the
        map placed once."""
        if self.csr_topo.eid is None:
            return True
        if self._eid is None:
            self._eid = self._put(self.csr_topo.eid, "the edge-id map")
        return self._eid

    def reshuffle(self, generator: Optional[torch.Generator] = None):
        """Re-shuffle every CSR row's neighbour order, rotation and window
        sampling's freshness source; the edge weights, when given, ride
        the same shuffle into their own rows view. Called on the first
        ``sample``; call it at each epoch boundary after.
        ``shuffle="sort"``: an exact
        uniform shuffle per row (one sort over the edge array);
        ``"butterfly"``: the cheaper swap network, composed across calls
        (the running order and edge-id map are kept here). Draws from the
        sampler's generator unless one is given.

        It runs on the sampler's device in both modes. HOST mode then
        copies the rows views (and the butterfly state and edge-id map)
        into pinned buffers allocated on the first call and keeps no
        E-sized array on the card."""
        self.lazy_init_quiver()
        dev = self.device
        gen = self.generator if generator is None else generator
        indptr, indices = self._placed
        row_ids = self._row_ids
        if row_ids is None:
            row_ids = edge_row_ids(indptr.to(dev), int(indices.shape[0]))
            if self.mode != "HOST":
                self._row_ids = row_ids
        bfly = self.shuffle == "butterfly"
        weighted = self.edge_weight is not None
        src = self._permuted if bfly and self._permuted is not None \
            else indices
        extra = None
        if weighted:
            wsrc = self._permuted_w if bfly and self._permuted_w is not None \
                else self._ensure_weights_placed()
            extra = (wsrc.to(dev),)
        out = reshuffle_csr(src.to(dev), row_ids, gen, method=self.shuffle,
                            with_slot_map=self.with_eid, extra=extra)
        if not isinstance(out, tuple):
            out = (out,)
        permuted, out = out[0], out[1:]
        wp = out[0][0] if weighted else None
        smap = out[-1] if self.with_eid else None
        del row_ids, out, extra
        if self.with_eid:
            prev = None if self._rot_eid is None else self._rot_eid.to(dev)
            self._rot_eid = self._refill(
                self._rot_eid,
                compose_slot_map(prev, smap, self.csr_topo.eid, bfly),
                "the shuffled edge-id map")
            del prev, smap
        as_rows = (as_index_rows_overlapping if self.layout == "overlap"
                   else as_index_rows)
        self._rot = self._refill(self._rot, as_rows(permuted),
                                 "the shuffled rows")
        if weighted:
            self._rot_w = self._refill(self._rot_w, as_rows(wp),
                                       "the shuffled weight rows")
        if bfly:
            self._permuted = self._refill(self._permuted, permuted,
                                          "the butterfly state")
            if weighted:
                self._permuted_w = self._refill(
                    self._permuted_w, wp, "the butterfly weight state")

    def _exact_hub_frac(self):
        """The hub fraction that sizes the wide-exact budget of scattered
        reads (``CSRTopo.exact_bucket_meta``, cached on the topology);
        None when the wide-exact path is not in play (it never is with
        weights: the pool draw reads scattered)."""
        if self.sampling != "exact" or not self.wide_exact \
                or self.edge_weight is not None:
            return None
        return float(self.csr_topo.exact_bucket_meta(step=128).frac)

    # -- core -----------------------------------------------------------------
    def sample(self, input_nodes):
        """Returns ``(n_id, batch_size, adjs)``, the adjs outermost hop
        first, ready for layer-wise message passing (PyG's order). With
        ``collect_metrics`` the batch's counter vector lands on
        ``last_counters``."""
        self.lazy_init_quiver()
        seeds = torch.as_tensor(input_nodes).to(self.device, torch.int32)
        bs = int(seeds.shape[0])
        indptr, indices = self._placed
        weights = None if self.edge_weight is None \
            else self._ensure_weights_placed()
        if self.sampling in _WINDOWED:
            if self._rot is None:
                self.reshuffle()
            rows, w_rows, eid = self._rot, self._rot_w, self._rot_eid
        else:
            # a rows view of the same un-shuffled indices (Fisher-Yates
            # positions are uniform under any fixed order); the weighted
            # pool draw has no use for one
            rows = self._ensure_exact_rows() \
                if self.wide_exact and weights is None else None
            w_rows = None
            eid = self._eid_map() if self.with_eid else None
        stride = 128 if rows is not None and self.layout == "overlap" \
            else None
        col = metrics.Collector(self.device) if self.collect_metrics \
            else None
        n_id, layers = sample_multihop(
            indptr, indices, seeds, self.sizes, self.generator,
            edge_weight=weights, method=self.sampling, indices_rows=rows,
            eid=eid, indices_stride=stride, weight_rows=w_rows,
            hub_frac=self._exact_hub_frac(), collector=col)
        if col is not None:
            self.last_counters = col.counters()
        adjs = [Adj(edge_index=torch.stack([layer.col, layer.row]),
                    e_id=layer.e_id, size=(shape.n_id_cap, shape.num_seeds),
                    mask=layer.col >= 0)
                for layer, shape in zip(layers, layer_shapes(bs, self.sizes))]
        return n_id, bs, adjs[::-1]

    # -- aux ------------------------------------------------------------------
    def sample_layer(self, batch, size: int):
        self.lazy_init_quiver()
        seeds = torch.as_tensor(batch).to(self.device, torch.int32)
        return sample_layer(*self._placed, seeds, int(size), self.generator)

    def reindex(self, inputs, outputs, counts=None):
        return compact_layer(torch.as_tensor(inputs).to(torch.int32),
                             torch.as_tensor(outputs).to(torch.int32))

    def sample_prob(self, train_idx, total_node_count: int):
        self.lazy_init_quiver()
        indptr, indices = (t.to(self.device) for t in self._placed)
        return sample_prob(indptr, indices,
                           torch.as_tensor(train_idx, device=self.device),
                           self.sizes, total_node_count)

    # -- process sharing ------------------------------------------------------
    def share_ipc(self):
        return (self.csr_topo, self.device, self.mode, self.sizes,
                self.edge_weight, self.sampling, self.with_eid,
                self.layout, self.shuffle, self.wide_exact,
                self.allow_fallback)

    @classmethod
    def lazy_from_ipc_handle(cls, ipc_handle):
        # short handles (7-tuple: no layout/shuffle; 9-tuple: no
        # wide_exact/allow_fallback) load with the constructor's defaults
        (csr_topo, device, mode, sizes, edge_weight, sampling,
         with_eid) = ipc_handle[:7]
        extras = {}
        for pos, name in ((7, "layout"), (8, "shuffle"),
                          (9, "wide_exact"), (10, "allow_fallback")):
            if len(ipc_handle) > pos:
                extras[name] = ipc_handle[pos]
        return cls(csr_topo, sizes, device=device, mode=mode,
                   edge_weight=edge_weight, sampling=sampling,
                   with_eid=with_eid, **extras)


class SampleJob(Generic[T_co]):
    """Abstract shuffled task source for the mixed sampler (the
    reference's ``SampleJob``)."""

    def __getitem__(self, index) -> T_co:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError
