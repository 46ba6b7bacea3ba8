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
  HBM mode, so for the same seed both give the same picks;
- ``"CPU"``: every hop on the host by the native C++ engine
  (``native/``), over host copies of the topology (and of the weights
  and the edge-id map) made once. Each batch's engine seed is drawn from
  the sampler's generator, which lies on the host in this mode; the
  batch's ``n_id`` and adjs go to the sampler's device in one
  ``non_blocking`` copy from one pinned buffer. Windowed methods fall
  back to ``"exact"``, as in the JAX package.

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
``last_counters``, counted on the card without a host synchronisation
(CPU mode counts nothing and leaves it None, as JAX does).

``MixedGraphSageSampler`` shares a ``SampleJob``'s batches between a
device sampler (HBM or HOST mode) on the calling thread and CPU-mode
samplers on a thread pool, in proportion to their measured times.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
import weakref
from typing import Generic, List, NamedTuple, Optional, Sequence, TypeVar

import numpy as np
import torch

from ..ops.sample import (as_index_rows, as_index_rows_overlapping,
                          compact_layer, compose_slot_map, edge_row_ids,
                          reshuffle_csr, sample_layer, sample_prob)
from .. import metrics, native
from ..ops.sample_multihop import sample_multihop
from ..utils.device import resolve_device
from ..utils.placement import pinned_put

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


def _pack(groups, device: torch.device) -> List[torch.Tensor]:
    """Each group (a tuple of numpy arrays of one shape and dtype) as one
    tensor on ``device``, the group's arrays stacked along a new first
    axis (a group of one keeps its shape). All lie in one host buffer,
    pinned for a CUDA device and moved there in one ``non_blocking``
    copy; the tensors are views of the copy."""
    sizes = [sum(a.nbytes for a in g) for g in groups]
    offs = np.concatenate([[0], np.cumsum([-(-n // 8) * 8 for n in sizes])])
    cuda = device.type == "cuda"
    buf = torch.empty(int(offs[-1]), dtype=torch.uint8, pin_memory=cuda)
    host = buf.numpy()
    for g, off in zip(groups, offs.tolist()):
        for a in g:
            host[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1) \
                .view(np.uint8)
            off += a.nbytes
    dev = buf.to(device, non_blocking=True) if cuda else buf
    out = []
    for g, off, n in zip(groups, offs.tolist(), sizes):
        dtype = torch.from_numpy(np.empty(0, g[0].dtype)).dtype
        shape = g[0].shape if len(g) == 1 else (len(g),) + g[0].shape
        out.append(dev[off:off + n].view(dtype).reshape(shape))
    return out


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
    (``None``: the card; in CPU mode the device the batches are put
    on). ``allow_fallback`` is kept in the signature and the IPC handle;
    pinning cannot fall back here (``utils/placement.py``)."""

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
        # CPU mode draws only the engine's integer seed, on the host
        self.generator = torch.Generator(
            device="cpu" if mode == "CPU" else self.device).manual_seed(seed)
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
        """``t`` where the sampler reads it: the card (HBM), pinned host
        memory (HOST; plain host memory for the CPU), or a contiguous
        host copy (CPU mode, for the engine)."""
        if self.mode == "HOST":
            return pinned_put(t, self.device, what)
        if self.mode == "CPU":
            return torch.as_tensor(t).cpu().contiguous()
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
        if self._placed is not None:
            return
        if self.mode != "CPU":
            self._placed = (self._put(self.csr_topo.indptr, "the indptr"),
                            self._put(self.csr_topo.indices, "the indices"))
            return
        # the engine's host copies, made once: int64 offsets, int32 ids,
        # fp32 weights, the edge-id map
        topo = self.csr_topo
        if self.edge_weight is not None:
            self._ensure_weights_placed()
        if self.with_eid:
            self._eid_map()
        self._placed = (topo.indptr.to("cpu", torch.int64).contiguous(),
                        topo.indices.to("cpu", torch.int32).contiguous())

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
                or self.edge_weight is not None or self.mode == "CPU":
            return None
        return float(self.csr_topo.exact_bucket_meta(step=128).frac)

    # -- core -----------------------------------------------------------------
    def sample(self, input_nodes):
        """Returns ``(n_id, batch_size, adjs)``, the adjs outermost hop
        first, ready for layer-wise message passing (PyG's order). With
        ``collect_metrics`` the batch's counter vector lands on
        ``last_counters``."""
        self.lazy_init_quiver()
        if self.mode == "CPU":
            return self._sample_cpu(input_nodes)
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

    def _sample_cpu(self, input_nodes):
        """CPU mode: every hop by the native engine, seeded from the
        sampler's generator; the edge ids go through the topology's eid
        map (CSR slots without one). The batch is laid out in one pinned
        host buffer (plain memory for the CPU) and copied to the device
        in one ``non_blocking`` copy, its arrays then views of it."""
        seeds = torch.as_tensor(input_nodes).to("cpu", torch.int32).numpy()
        bs = int(seeds.shape[0])
        indptr, indices = (t.numpy() for t in self._placed)
        weights = None if self.edge_weight is None \
            else self._weight_placed.numpy()
        seed = int(torch.randint(0, 2**31 - 1, (),
                                 generator=self.generator))
        out = native.cpu_sample_multihop(
            indptr, indices, seeds, self.sizes, seed=seed, weights=weights,
            with_slots=self.with_eid)
        groups = [(out[0],)]
        eid = self._eid_map() if self.with_eid else True
        for hop, (row, col) in enumerate(zip(out[1], out[2])):
            groups.append((col, row))
            if self.with_eid:
                slots = out[3][hop]
                if eid is not True:
                    slots = np.where(slots >= 0,
                                     eid.numpy()[np.clip(slots, 0, None)],
                                     -1)
                groups.append((slots,))
        views = iter(_pack(groups, self.device))
        n_id = next(views)
        adjs = []
        for shape in layer_shapes(bs, self.sizes):
            edge_index = next(views)
            adjs.append(Adj(edge_index=edge_index,
                            e_id=next(views) if self.with_eid else None,
                            size=(shape.n_id_cap, shape.num_seeds),
                            mask=edge_index[0] >= 0))
        return n_id, bs, adjs[::-1]

    # -- aux ------------------------------------------------------------------
    def sample_layer(self, batch, size: int):
        """One hop of the sampler's method from its generator (the
        reference's ``sample_layer``); CPU mode samples it on the host
        and returns it on the sampler's device."""
        self.lazy_init_quiver()
        dev = "cpu" if self.mode == "CPU" else self.device
        seeds = torch.as_tensor(batch).to(dev, torch.int32)
        out = sample_layer(*self._placed, seeds, int(size), self.generator)
        return tuple(t.to(self.device) for t in out)

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


class MixedGraphSageSampler:
    """Hybrid device and host sampling scheduler (the reference's
    ``MixedGraphSageSampler``, JAX ``pyg/sage_sampler.py:596-772``).

    Iterating yields ``sample()`` results for every batch of the job,
    each once, in completion order. The device side is a
    ``GraphSageSampler`` in ``device_mode`` (``"HBM"`` or ``"HOST"``) run
    on the calling thread; the host side is a ``mode="CPU"`` sampler on a
    pool of ``num_workers`` threads (the engine releases the GIL). Each
    round hands the host a share of tasks in proportion to the measured
    per-task times (an EMA, ``EMA_ALPHA``), keeps the pool fed up to its
    width, and never waits for the slowest host task before the next
    device task (no round barrier). A device task's time ends with that
    batch's own completion: an event recorded after its ``sample`` and
    waited for, not a device-wide synchronisation, which would also wait
    for the host batches' copies.

    ``device_sampler_kwargs`` go to the device side; ``edge_weight`` and
    ``with_eid`` reach the host side too, whose weighted draw has the
    device pool draw's contract. Weighted windowed sampling is refused:
    the host engine has only the exact pool draw, and batches would skew
    by which engine made them. Rotation and window samplers are
    reshuffled at each epoch boundary."""

    #: EMA smoothing of the per-task time estimates
    EMA_ALPHA = 0.25

    def __init__(self, sample_job: SampleJob, sizes: Sequence[int],
                 csr_topo, device=None, device_mode: str = "HBM",
                 num_workers: int = 2, seed: int = 0,
                 **device_sampler_kwargs):
        if device_sampler_kwargs.get("edge_weight") is not None and \
                device_sampler_kwargs.get("sampling", "exact") != "exact":
            raise ValueError(
                "mixed weighted sampling pins sampling='exact': the "
                "host engine mirrors the exact weighted pool draw, and "
                "the weighted windowed draw (rotation/window) is a "
                "different distribution — batches would skew depending "
                "on which engine produced them")
        self.job = sample_job
        self.sizes = list(sizes)
        self.num_workers = max(1, num_workers)
        self._device_kwargs = dict(device_sampler_kwargs)
        self.device_sampler = GraphSageSampler(
            csr_topo, sizes, device=device, mode=device_mode, seed=seed,
            **device_sampler_kwargs)
        self.cpu_sampler = GraphSageSampler(
            csr_topo, sizes, device=self.device_sampler.device, mode="CPU",
            seed=seed + 1,
            edge_weight=device_sampler_kwargs.get("edge_weight"),
            with_eid=bool(device_sampler_kwargs.get("with_eid", False)))
        self._pool = None
        self._pool_finalizer = None
        self._device_time = None       # EMA seconds per device task
        self._cpu_time = None          # EMA seconds per host task
        self._time_lock = threading.Lock()   # host tasks run on the pool
        # batches each engine took since the sampler was made
        self.tasks = {"device": 0, "cpu": 0}

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="quiver-mixed-cpu")
            # a dropped sampler leaks no threads (bound to the pool)
            self._pool_finalizer = weakref.finalize(
                self, self._pool.shutdown, wait=False)

    def close(self):
        """Shut the host pool down (idempotent); the next iteration makes
        a new one."""
        pool, self._pool = self._pool, None
        if pool is not None:
            self._pool_finalizer.detach()
            pool.shutdown(wait=True, cancel_futures=True)

    def _ema(self, old, dt):
        a = self.EMA_ALPHA
        return dt if old is None else a * dt + (1.0 - a) * old

    def decide_task_num(self):
        """This round's ``(device tasks, host tasks)``: the host's share
        is the device tasks scaled by the pool width over the host/device
        time ratio, at most ``device tasks x num_workers``; before both
        times are measured, one task per worker."""
        device_tasks = max(20, 2 * self.num_workers)
        if not self._device_time or not self._cpu_time:
            return device_tasks, self.num_workers
        ratio = self._cpu_time / max(self._device_time, 1e-9)
        cpu_tasks = min(
            int(device_tasks / max(ratio / self.num_workers, 1e-9)),
            device_tasks * self.num_workers)
        return device_tasks, max(0, cpu_tasks)

    def _device_one(self, seeds):
        t0 = time.perf_counter()
        out = self.device_sampler.sample(seeds)
        if out[0].is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out[0].device))
            done.synchronize()
        self._device_time = self._ema(self._device_time,
                                      time.perf_counter() - t0)
        self.tasks["device"] += 1
        return out

    def _cpu_one(self, seeds):
        t0 = time.perf_counter()
        out = self.cpu_sampler.sample(seeds)
        dt = time.perf_counter() - t0
        with self._time_lock:
            self._cpu_time = self._ema(self._cpu_time, dt)
            self.tasks["cpu"] += 1
        return out

    def __iter__(self):
        self.job.shuffle()
        if self.device_sampler.sampling in _WINDOWED and \
                self.device_sampler._rot is not None:
            # the epoch boundary: this layer knows it (it just reshuffled
            # the job), so it refreshes the row order too
            self.device_sampler.reshuffle()
        self.cpu_sampler.lazy_init_quiver()   # once, not on pool threads
        self._ensure_pool()
        n = len(self.job)
        idx = 0
        pending: List = []

        def drain_done():
            nonlocal pending
            done = [f for f in pending if f.done()]
            pending = [f for f in pending if not f.done()]
            return done

        while idx < n or pending:
            device_quota, cpu_quota = self.decide_task_num()

            def dispatch_host():
                # feed the pool up to its width within this round's
                # quota, never past it: a queue beyond the width is
                # backlog, and before the first host measurement it could
                # commit many batches to a host far slower than the card
                nonlocal idx, cpu_quota
                while (idx < n and cpu_quota > 0
                       and len(pending) < self.num_workers):
                    seeds = self.job[idx]
                    idx += 1
                    cpu_quota -= 1
                    pending.append(self._pool.submit(self._cpu_one, seeds))

            dispatch_host()
            # device tasks inline, finished host tasks yielded between
            # them without blocking, the pool refilled as slots free up
            for _ in range(device_quota):
                if idx >= n:
                    break
                seeds = self.job[idx]
                idx += 1
                yield self._device_one(seeds)
                for fut in drain_done():
                    yield fut.result()
                dispatch_host()
            for fut in drain_done():
                yield fut.result()
            if idx >= n and pending:
                # everything dispatched: now waiting is idle, not a stall
                done, rest = cf.wait(pending,
                                     return_when=cf.FIRST_COMPLETED)
                pending = list(rest)
                for fut in done:
                    yield fut.result()

    def share_ipc(self):
        return (self.job, self.sizes, self.device_sampler.csr_topo,
                self.device_sampler.device, self.device_sampler.mode,
                self.num_workers, self._device_kwargs)

    @classmethod
    def lazy_from_ipc_handle(cls, handle):
        # 6-tuple handles (no device kwargs) load too
        job, sizes, csr_topo, device, mode, workers = handle[:6]
        kwargs = handle[6] if len(handle) > 6 else {}
        return cls(job, sizes, csr_topo, device=device,
                   device_mode=mode, num_workers=workers, **kwargs)
