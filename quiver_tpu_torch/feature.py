"""Tiered feature store (counterpart of ``quiver_tpu/feature.py``).

Three tiers, by bandwidth:
  1. the hot tier on the card: the hottest rows (degree-ordered through
     ``feature_order``, the reference's hot-order permutation), as many
     as ``device_cache_size`` bytes hold under the hot dtype policy.
     With ``cache_policy="p2p_clique_replicate"`` (or ``"shard"``) over
     a clique of cards (``mesh``, or ``device_list``), the cards pool
     their budgets and the hot rows are cut into one block a card
     (``quant.ShardedTier``, an int8 tier in packed rows); a lookup from
     the store's card reads local and peer blocks in one launch of
     ``ops/kernels/gather.py: gather_rows_sharded``, the reference's
     NVLink clique;
  2. the cold tier, the remaining rows, in host memory. With
     ``host_placement="offload"`` it is pinned and the card reads it
     itself: the CUDA row gather (``ops/kernels/gather.py``) takes device
     ids and reads the rows over PCIe, the reference's UVA gather; an
     int8 tier is pinned packed (``quant.pack``), each row's codes,
     scale and zero in one host row that the gather reads at once. With
     ``host_placement="numpy"`` it is a plain CPU tensor: a lookup
     brings its ids to the host, indexes there and copies the rows to
     the card;
  3. the disk tier (``set_mmap_file``): an mmap'd ``[rows, dim]`` file,
     int8 with resident sidecars or plain, and ``disk_map`` from storage
     row to file row. When it is attached, every row past the hot tier
     is read from it: a lookup brings its translated ids to the host,
     reads the cold rows and copies them into the card's output. With
     ``enable_cold_prefetch`` a prefetcher (``prefetch.py``) stages the
     rows of published frontiers (``stage_frontier``) into a ring in
     pinned memory ahead of the lookup, which reads the ring's hits with
     the CUDA row gather straight into its output and the misses from
     the file.

Lookup ids pass through ``feature_order`` before tier dispatch. Every
entry point runs on the card unless the caller passes ``device="cpu"``;
there both tiers are CPU tensors and the gathers run their plain
versions.

The offload lookup (:meth:`Feature._lookup_tiered`) keeps the JAX
package's branches: no hot tier; a budget no smaller than the batch;
cold compaction into ``cold_budget`` host rows with its full-gather
fallback; and ``dedup_cold``'s unique table with its fallback to
compaction. Where JAX picks a branch with ``lax.cond``, this lookup
never asks the host: each branch's host gather is given -1 at every
slot the branch would not read (the gather skips those), so a branch
that is not taken reads nothing, and results merge on the card. Host
rows read per batch stay within JAX's bound (``budget`` on the narrow
path, ``budget`` more on unique overflow, and the batch's cold slots
when the raw cold count overflows too): the unique rows on the dedup
narrow path, the cold slots on the compaction path, and the cold slots
alone when they overflow the budget.

``lookup_tiered(collect_metrics=True)`` also returns the lookup's device
counters (``metrics.py``): hot and cold rows on the classification mask,
and the dedup table's statistics, recorded where the JAX lookup records
them (outside its branches), so a predicated branch that is not taken
records nothing. ``rotate_hot_set`` swaps rows between the tiers online;
a store pickles with its pinned tier as a CPU copy (and a disk store
without its prefetcher, as in JAX). ``share_ipc`` hands a store to a
``torch.multiprocessing`` worker without copying its tiers: device
tiers by CUDA IPC, the cold tier as shared host memory that the worker
pins again (``multiprocessing/reductions.py``).

``prefetch(ids)`` runs a lookup on a depth-2 staging ``Pipeline``
(``pipeline.py``) and returns a future of ``feature[ids]``: a training
loop stages batch i+1's rows while the card runs batch i's step. On the
card the worker launches the lookup on a CUDA stream of its own, so the
lookup's kernels can run beside the step's, and hands the rows back
through an event that the reader's stream waits for.
"""

from __future__ import annotations

import functools
from concurrent.futures import Future
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import faults, metrics, tracing
from .comm import (build_dist_lookup_fn, cap_for_expected_load,
                   default_exchange_cap)
from .pipeline import Pipeline
from .profiling import hot_path
from .ops import quant
from .ops.dedup import dedup_take, unique_within_budget
from .ops.kernels._build import gated
from .ops.kernels.gather import gather_rows, prepare_sharded
from .parallel.mesh import Mesh, make_mesh, row_sharded
from .utils.device import resolve_device
from .utils.placement import pinned_put, register_host, share_host
from .utils.reorder import reindex_feature
from .utils.sizes import parse_size
from .utils.topo import init_p2p


class DeviceConfig:
    """Pre-partitioned construction recipe (reference feature.py:11-14):
    ``gpu_parts`` land in the hot tier, ``cpu_part`` in the cold tier."""

    def __init__(self, gpu_parts, cpu_part):
        self.gpu_parts = gpu_parts
        self.cpu_part = cpu_part

    @property
    def device_parts(self):
        return self.gpu_parts

    @property
    def host_part(self):
        return self.cpu_part


def _resolve_tier_policy(policy) -> dict:
    """A dtype-policy knob as ``{"hot": ..., "cold": ...}`` with
    canonical policy names (None = store as it is)."""
    if policy is None or isinstance(policy, str):
        p = quant.resolve_policy(policy)
        return {"hot": p, "cold": p}
    if isinstance(policy, dict):
        unknown = set(policy) - {"hot", "cold"}
        if unknown:
            raise ValueError(
                f"dtype_policy keys must be 'hot'/'cold', got "
                f"{sorted(unknown)}")
        return {"hot": quant.resolve_policy(policy.get("hot")),
                "cold": quant.resolve_policy(policy.get("cold"))}
    raise ValueError(f"cannot parse dtype_policy {policy!r}")


def _resolve_cold_budget(dedup_cold, cold_budget, n: int) -> int:
    """The cold-compaction budget for an ``n``-slot lookup: an explicit
    ``dedup_cold=int`` wins, then ``cold_budget``, then the default."""
    if dedup_cold and not isinstance(dedup_cold, bool):
        return int(dedup_cold)
    if cold_budget is not None:
        return cold_budget
    return quant.default_cold_budget(n)


def _dedup_counts(budget: int, raw: dict) -> dict:
    """The dedup path's span counters from the raw ones it staged: on
    unique overflow the compaction reads every cold slot."""
    over = raw["unique"] > budget
    return {"cold_slots": raw["cold_slots"], "dedup_overflow": int(over),
            "host_rows": raw["cold_slots"] if over else raw["live_rows"]}


class _StagedRows(Future):
    """The future :meth:`Feature.prefetch` returns. The worker sets it to
    ``(rows, done)``, ``done`` the CUDA event recorded on the staging
    stream after the lookup (None on the CPU). ``result()`` returns the
    rows, and on the card first makes the caller's current stream wait
    for ``done`` and records the rows' use on that stream, so the caching
    allocator does not give their memory back to the staging stream while
    the reader's kernels still run. Nothing waits for the card."""

    def result(self, timeout=None):
        rows, done = super().result(timeout)
        if done is not None:
            stream = torch.cuda.current_stream(rows.device)
            stream.wait_event(done)
            rows.record_stream(stream)
        return rows


def _default_mesh(device_list, device) -> Mesh:
    """The clique a sharded store spans without a ``mesh``: the cards of
    ``device_list`` (at least two entries); on the CPU, as many entries
    of ``cpu``."""
    if device.type == "cpu":
        return make_mesh(("cache",), devices=[device] * len(device_list))
    return make_mesh(("cache",), devices=[torch.device("cuda", i)
                                           for i in device_list])


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def _shard_tier(tier, placement, home) -> quant.ShardedTier:
    """A hot tier row-sharded over ``placement``'s mesh axis (JAX
    ``feature.py:357-372``): ``ceil(rows / n)`` rows a block, the last
    padded with zero rows, block ``s`` on ``mesh.devices.flat[s]``; an
    int8 tier's blocks packed (``quant.pack``), as the gather reads
    them. Peer access is enabled between the blocks' cards."""
    devices = list(placement.mesh.devices.flat)
    n, rows = len(devices), quant.tier_rows(tier)
    block = -(-rows // n)
    shards = []
    for s, d in enumerate(devices):
        lo, hi = min(s * block, rows), min((s + 1) * block, rows)
        part = quant.tree_map_tier(lambda t: _pad_rows(t[lo:hi], block),
                                   tier)
        if quant.is_quantized(part):
            shards.append(quant.pack(part, device=d))
        else:
            shards.append(part.to(d).contiguous())
    if home.type == "cuda":
        init_p2p(devices)
    return prepare_sharded(quant.ShardedTier(
        shards, [s * block for s in range(n + 1)], home))


def _cpu_tensor(a) -> torch.Tensor:
    """A host table (numpy array or tensor) as a CPU tensor."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t.cpu()


def _load_sidecar(s):
    """A disk tier's sidecar given as a path, an array or a tensor."""
    if s is None:
        return None
    if isinstance(s, str):
        return np.load(s)
    return s.detach().cpu().numpy() if torch.is_tensor(s) else np.asarray(s)


class Feature:
    """``Feature(rank, device_list, device_cache_size, cache_policy,
    csr_topo)``: the reference's constructor (feature.py:37-59) and the
    JAX package's knobs, plus ``device`` (the card unless ``"cpu"``).

    ``dtype_policy`` stores each tier narrow (``None``, ``"bf16"``,
    ``"fp16"``, ``"int8"``, or ``{"hot": ..., "cold": ...}``; mixed
    tiers merge at the wider dtype). ``cold_budget`` caps the host rows
    an offload lookup reads per batch (default ``max(n // 4, 256)``);
    ``dedup_cold`` (True, or an int unique budget) reads each distinct
    cold row once.

    ``cache_policy="device_replicate"`` keeps the hot tier whole on the
    store's card. ``"p2p_clique_replicate"`` and ``"shard"`` row-shard
    it over a clique, as JAX shards it over its mesh: ``mesh`` (a
    ``parallel.make_mesh`` mesh; its first axis splits the rows), else
    the cards of ``device_list``; the byte budget is each card's, so the
    clique holds ``mesh size`` times as many hot rows. The store's card
    (where its lookups run) is ``device``, else the mesh's first entry,
    else ``device_list[rank]``. A clique of one card is replicated, as in
    JAX: without ``mesh`` and with at most one ``device_list`` entry, a
    clique policy keeps the hot tier whole on the store's card. A mesh
    may name one card several times: each block is then its own
    allocation on it, read as a peer's would be."""

    def __init__(self, rank: int = 0,
                 device_list: Optional[Sequence[int]] = None,
                 device_cache_size=0,
                 cache_policy: str = "device_replicate",
                 csr_topo=None,
                 mesh=None,
                 dtype=None,
                 host_placement: str = "numpy",
                 cold_budget: Optional[int] = None,
                 dedup_cold=False,
                 dtype_policy=None,
                 device=None):
        if cache_policy not in ("device_replicate", "p2p_clique_replicate",
                                "shard"):
            raise ValueError(f"unknown cache_policy {cache_policy!r}")
        if host_placement not in ("numpy", "offload"):
            raise ValueError(f"unknown host_placement {host_placement!r}")
        if device is None and cache_policy != "device_replicate":
            if mesh is not None:
                device = mesh.devices.flat[0]
            elif device_list:
                device = torch.device("cuda", device_list[
                    rank if rank < len(device_list) else 0])
        self.device = resolve_device(device)
        self.rank = rank
        self.mesh = mesh
        self.device_list = list(device_list) if device_list else None
        self.device_cache_size = device_cache_size
        self.cache_policy = cache_policy
        self.csr_topo = csr_topo
        self.dtype = dtype
        self.host_placement = host_placement
        self.cold_budget = cold_budget
        self.dedup_cold = dedup_cold
        self.dtype_policy = _resolve_tier_policy(dtype_policy)
        self.feature_order = None      # old id -> storage row, int32
        self.cache_rows = 0
        self.device_part = None        # hot tier on the device
        self.host_part = None          # cold tier gathered on the host
        self._host_offload = None      # cold tier the card reads (pinned)
        self._pool = None              # prefetch's staging pipeline
        self._stage_stream = None      # its CUDA stream (on the card)
        self.mmap_array = None         # the disk tier: np.memmap rows
        self.disk_map = None           # int64 numpy, storage -> file row
        self.disk_scale = None         # numpy int8 sidecars [rows, 1]
        self.disk_zero = None
        self._cold_prefetch = None     # prefetch.ColdPrefetcher
        self._order_np = None          # (feature_order, its host copy)

    # -- sizing (reference feature.py:74-82) --------------------------------
    def cal_size(self, cpu_tensor, cache_memory_budget: int) -> int:
        """Hot rows that ``cache_memory_budget`` bytes hold: the budget
        divided by the stored row width under the hot dtype policy."""
        itemsize = cpu_tensor.element_size() if torch.is_tensor(cpu_tensor) \
            else np.asarray(cpu_tensor).dtype.itemsize
        row_bytes = quant.row_bytes(int(np.prod(cpu_tensor.shape[1:])),
                                    self.dtype_policy["hot"], itemsize)
        return min(cpu_tensor.shape[0],
                   cache_memory_budget // max(row_bytes, 1))

    def partition(self, cpu_tensor, cache_memory_budget: int):
        rows = self.cal_size(cpu_tensor, cache_memory_budget)
        return [cpu_tensor[:rows], cpu_tensor[rows:]]

    # -- construction -------------------------------------------------------
    def from_cpu_tensor(self, cpu_tensor):
        """Build both tiers from a host table (numpy or a tensor). With a
        ``csr_topo`` the rows are stored degree-descending: the topo's
        ``feature_order`` is computed here, or reused when an earlier
        store set it, and this table is permuted by it either way. A
        table already on the store's card is permuted and quantized
        there, and only its cold tier comes to host memory (a table of
        gigabytes then never lies in host memory whole)."""
        on_card = torch.is_tensor(cpu_tensor) and cpu_tensor.is_cuda \
            and self.device.type == "cuda" and cpu_tensor.device.index == (
                torch.cuda.current_device() if self.device.index is None
                else self.device.index)
        tensor = cpu_tensor.detach() if on_card else _cpu_tensor(cpu_tensor)
        if self.dtype is not None:
            tensor = tensor.to(quant.torch_dtype(self.dtype))
        budget = parse_size(self.device_cache_size)
        if self.cache_policy != "device_replicate":
            # the clique's cards pool their budgets
            budget *= self._mesh_size()
        if self.csr_topo is not None:
            if self.csr_topo.feature_order is None:
                _, new_order = reindex_feature(self.csr_topo, None, 0)
                self.csr_topo.feature_order = new_order
            order = self.csr_topo.feature_order
            storage = torch.empty_like(tensor)
            storage.index_copy_(0, order.to(tensor.device).long(), tensor)
            tensor = storage
            self.feature_order = order.to(self.device, torch.int32)
        cache_part, host_part = self.partition(tensor, budget)
        self.cache_rows = int(cache_part.shape[0])
        self._place(quant.quantize(cache_part, self.dtype_policy["hot"]))
        self.host_part = None
        if host_part.shape[0]:
            self.host_part = quant.tree_map_tier(
                lambda t: t.cpu().contiguous(),
                quant.quantize(host_part, self.dtype_policy["cold"]))
        self._maybe_offload_host()
        return self

    def from_mmap(self, np_array, device_config: DeviceConfig):
        """Build from pre-partitioned parts (reference feature.py:95-192):
        ``device_config.gpu_parts`` concatenated into the hot tier,
        ``cpu_part`` (or ``np_array`` when there is neither) the cold."""
        parts = [_cpu_tensor(p) for p in device_config.device_parts
                 if p is not None]
        parts = [p for p in parts if p.numel()]
        host = device_config.host_part
        host = None if host is None else _cpu_tensor(host)
        if parts:
            cache_part = torch.cat(parts)
        else:
            cache_part = host.new_zeros((0,) + tuple(host.shape[1:]))
        self.cache_rows = int(cache_part.shape[0])
        if self.cache_rows:
            self._place(quant.quantize(cache_part, self.dtype_policy["hot"]))
        raw = host if host is not None and host.numel() else None
        if raw is None and np_array is not None and not self.cache_rows:
            raw = np_array
        self.host_part = None if raw is None else quant.tree_map_tier(
            torch.Tensor.contiguous,
            quant.quantize(_cpu_tensor(raw), self.dtype_policy["cold"]))
        self._maybe_offload_host()
        return self

    def _mesh_size(self) -> int:
        if self.mesh is not None:
            return self.mesh.size
        return len(self.device_list) if self.device_list else 1

    def _place(self, cache_part):
        if quant.tier_rows(cache_part) == 0:
            self.device_part = None
            return
        if self.cache_policy == "device_replicate" or self._mesh_size() == 1:
            self.device_part = quant.tree_map_tier(
                lambda t: t.to(self.device).contiguous(), cache_part)
            return
        # p2p_clique_replicate / shard: row-shard over the mesh's axis
        if self.mesh is None:
            self.mesh = _default_mesh(self.device_list, self.device)
        self.device_part = _shard_tier(
            cache_part, row_sharded(self.mesh, self.mesh.axis_names[0]),
            self.device)

    @property
    def sharded(self) -> bool:
        """Whether the hot tier is row-sharded over a clique."""
        return quant.is_sharded(self.device_part)

    def _maybe_offload_host(self):
        """``host_placement="offload"``: pin the cold tier for the card's
        gather. The pinned copy owns the tier, so host residency stays
        1x. On the CPU the tier stays a plain tensor."""
        if self.host_placement != "offload" or self.host_part is None:
            return
        self._host_offload = pinned_put(self.host_part, self.device,
                                        "the Feature host tier")
        self.host_part = None

    # -- the gathers ----------------------------------------------------------
    def _ids(self, node_idx) -> torch.Tensor:
        t = node_idx if torch.is_tensor(node_idx) \
            else torch.as_tensor(np.asarray(node_idx))
        return t.to(self.device)

    @staticmethod
    def _translate(ids, order):
        if order is None:
            return ids.to(torch.int32)
        return order[ids.long()]

    def _gather_cached(self, dev_part, ids):
        safe = ids.clamp(0, max(self.cache_rows - 1, 0))
        return quant.gather_rows(dev_part, safe)

    def _lookup_cached(self, dev_part, ids, order):
        return self._gather_cached(dev_part, self._translate(ids, order))

    def _lookup_cached_masked(self, dev_part, ids, order):
        ids_i = ids.to(torch.int32)
        safe = ids_i.clamp(0, max(self.cache_rows - 1, 0))
        rows = self._gather_cached(dev_part, self._translate(safe, order))
        return rows * (ids_i >= 0).to(rows.dtype)[:, None]

    @hot_path
    def _lookup_tiered(self, dev_part, host_part, ids, order,
                       masked: bool = False, collector=None):
        """The offload lookup (the JAX package's ``lookup_tiered_body``):
        hot rows from the device tier, cold rows read from the host tier
        by ``gather_rows``, without a host synchronisation. ``masked``:
        -1 ids give zero rows, and padding counts as hot (it never takes
        a cold budget slot). ``collector`` (a ``metrics.Collector``)
        records one lookup and its valid hot and cold slots (padding
        excluded), and the dedup table's statistics where JAX records
        them: once, when ``dedup_cold`` is on and the budget is below
        the batch; the compaction fallback records nothing.

        The call is the span ``feature.lookup``, its dedup
        ``feature.dedup`` and each host-tier read ``feature.host_gather``.
        While it records, the span counts ``cold_slots`` (valid cold
        slots), ``host_rows`` (rows read from the host tier: the live
        distinct cold rows on the dedup path, else the cold slots) and
        ``dedup_overflow`` (1 when the distinct rows overflowed the
        budget), from device scalars the lookup has (the dedup path adds
        one sum, of its live distinct cold rows) and, there, worked out
        on the host when the span is read (:func:`_dedup_counts`)."""
        with tracing.span("feature.lookup") as sp:
            return self._tiered(sp, dev_part, host_part, ids, order,
                                masked, collector)

    @hot_path
    def _tiered(self, sp, dev_part, host_part, ids, order, masked,
                collector):
        ids_raw = ids.to(torch.int32)
        cache_rows = self.cache_rows
        cold_total = quant.tier_rows(host_part)
        total = cache_rows + cold_total
        ids = ids_raw.clamp(0, total - 1) if masked else ids_raw
        out_dt = quant.tier_dtype(host_part)
        if dev_part is not None:
            out_dt = torch.promote_types(quant.tier_dtype(dev_part), out_dt)
        dev, n, dim = ids.device, ids.shape[0], quant.tier_dim(host_part)
        skip = torch.full_like(ids_raw, -1)

        def take_hot(hids):
            return self._gather_cached(dev_part, hids).to(out_dt)

        def put_host(x, hids):
            """Host rows over ``x`` where ``hids`` is not -1, in place."""
            with tracing.span("feature.host_gather"):
                if quant.tier_dtype(host_part) == out_dt:
                    return gather_rows(host_part, hids, out=x)
                rows = gather_rows(host_part, hids, out=torch.zeros(
                    (hids.shape[0], dim), dtype=quant.tier_dtype(host_part),
                    device=dev))
                return x.copy_(torch.where((hids >= 0)[:, None],
                                           rows.to(out_dt), x))

        def finish(rows):
            if not masked:
                return rows
            return rows * (ids_raw >= 0).to(rows.dtype)[:, None]

        t = self._translate(ids, order)
        hot = t < cache_rows
        if masked:
            hot = hot | (ids_raw < 0)
        if collector is not None:
            collector.add(metrics.LOOKUP_CALLS, 1)
            if masked:
                vmask = ids_raw >= 0
                hot_valid = (hot & vmask).sum(dtype=torch.int32)
                n_valid = vmask.sum(dtype=torch.int32)
            else:
                hot_valid = hot.sum(dtype=torch.int32)
                n_valid = n
            collector.add(metrics.HOT_ROWS, hot_valid)
            collector.add(metrics.COLD_ROWS, n_valid - hot_valid)
        cold_idx = (t - cache_rows).clamp(0, max(cold_total - 1, 0))
        budget = _resolve_cold_budget(self.dedup_cold, self.cold_budget, n)
        dedup = bool(self.dedup_cold)
        if dev_part is None:
            if sp.active:
                sp.count(cold_slots=(ids_raw >= 0).sum(dtype=torch.int32)
                         if masked else n)
            if dedup and budget < n:
                # no hot tier: every slot is cold, dedup still bounds the
                # host read to unique rows
                return finish(dedup_take(host_part, cold_idx, budget,
                                         collector=collector).to(out_dt))
            if sp.active:
                sp.count(host_rows=n, dedup_overflow=0)
            with tracing.span("feature.host_gather"):
                return finish(gather_rows(host_part, cold_idx).to(out_dt))
        zero = torch.zeros_like(t)
        if budget >= n:
            # the budget cannot beat a full gather: one read of every
            # cold slot (also the tiny-batch path)
            if sp.active:
                cold_slots = (~hot).sum(dtype=torch.int32)
                sp.count(cold_slots=cold_slots, host_rows=cold_slots,
                         dedup_overflow=0)
            x = take_hot(torch.where(hot, t, zero))
            return finish(put_host(x, torch.where(hot, skip, cold_idx)))

        def compacted(pred):
            """Cold compaction: hot rows per slot, up to ``budget`` cold
            slots filled from the host tier, or, when the raw cold count
            overflows, every cold slot by the full host gather instead
            (JAX reads the budget rows then too; they would only be read
            again). ``pred`` (a device bool, or None for always) gates
            its host reads: the dedup path runs it as its unique-overflow
            fallback."""
            x = take_hot(torch.where(hot, t, zero))
            x = torch.cat([x, x.new_zeros((1, dim))])      # row n: dropped
            cold = ~hot
            n_cold = cold.sum(dtype=torch.int32)
            over = n_cold > budget
            if pred is not None:
                over = over & pred
            crank = torch.cumsum(cold, 0, dtype=torch.int32) - 1
            sel = cold & (crank < budget)
            cpos = torch.full((budget + 1,), n, dtype=torch.int32,
                              device=dev)
            cpos.scatter_(0, torch.where(sel, crank, budget).long(),
                          torch.arange(n, dtype=torch.int32, device=dev))
            cpos = cpos[:budget]            # cold positions, n past n_cold
            live = (cpos < n) & (n_cold <= budget)
            if pred is not None:
                live = live & pred
            c_ids = cold_idx[cpos.clamp(max=n - 1).long()]
            rows = put_host(torch.zeros((budget, dim), dtype=out_dt,
                                        device=dev),
                            torch.where(live, c_ids, skip[:budget]))
            x.index_copy_(0, cpos.long(), rows)
            with gated():
                put_host(x[:n], torch.where(cold & over, cold_idx, skip))
            return x[:n], n_cold

        if not dedup:
            x, n_cold = compacted(None)
            if sp.active:
                sp.count(cold_slots=n_cold, host_rows=n_cold,
                         dedup_overflow=0)
            return finish(x)
        # the deduplicated narrow path: unique over the whole translated
        # frontier, each unique cold row read once ([budget, dim], the
        # only host read), positions expanded from the unique rows; on
        # unique overflow, the compaction path (which keeps its own
        # traffic bound) is taken instead
        valid_pos = (ids_raw >= 0) if masked else None
        with tracing.span("feature.dedup"):
            uniq, inv, n_uniq = unique_within_budget(
                t, budget, valid=valid_pos, collector=collector)
        uover = n_uniq > budget
        safe_u = uniq.clamp(0, total - 1)
        hot_u = safe_u < cache_rows
        rows_u = take_hot(torch.where(hot_u, safe_u, torch.zeros_like(uniq)))
        cold_u = (safe_u - cache_rows).clamp(0, max(cold_total - 1, 0))
        live_u = ~hot_u & ~uover & (
            torch.arange(budget, device=dev) < n_uniq)
        put_host(rows_u, torch.where(live_u, cold_u, skip[:budget]))
        if masked:
            # padding expands from a dedicated zero row
            rows_u = torch.cat([rows_u, rows_u.new_zeros((1, dim))])
            inv = torch.where(valid_pos, inv, budget)
        narrow = rows_u.index_select(0, inv.long())
        with gated():
            fallback, n_cold = compacted(uover)
        if sp.active:
            sp.count(cold_slots=n_cold, unique=n_uniq,
                     live_rows=live_u.sum(dtype=torch.int32))
            sp.derive(functools.partial(_dedup_counts, budget))
        if masked:
            return torch.where(uover, finish(fallback), narrow)
        return torch.where(uover, fallback, narrow)

    # -- lookup (reference feature.py:296-333) ------------------------------
    def __getitem__(self, node_idx):
        ids = self._ids(node_idx)
        if self.mmap_array is not None:
            return self._lookup_disk(ids)
        if self._host_offload is not None:
            return self._lookup_tiered(self.device_part, self._host_offload,
                                       ids, self.feature_order)
        if self.host_part is None:
            return self._lookup_cached(self.device_part, ids,
                                       self.feature_order)
        ids = self._translate(ids, self.feature_order)
        # mixed policies (bf16 hot + int8 cold) merge at the wider dtype,
        # as the offload lookup does, whether or not a batch has cold rows
        out_dt = quant.tier_dtype(self.host_part)
        if self.device_part is None:
            out = torch.zeros((ids.shape[0], self.dim()), dtype=out_dt,
                              device=self.device)
        else:
            out_dt = torch.promote_types(
                quant.tier_dtype(self.device_part), out_dt)
            out = self._gather_cached(self.device_part, ids).to(out_dt)
        ids_h = ids.cpu()                      # the host path: one sync
        pos = torch.nonzero(ids_h >= self.cache_rows).reshape(-1)
        if pos.numel() == 0:
            return out
        host_rows = quant.take_np(self.host_part,
                                  ids_h[pos] - self.cache_rows)
        # torch keeps no executable per shape, so unlike the JAX package
        # this scatter needs no power-of-two padding of the cold count
        return out.index_copy_(0, pos.to(self.device),
                               host_rows.to(self.device, out_dt))

    def _lookup_disk(self, ids, valid=None):
        """The lookup of a store with a disk tier (JAX's ``__getitem__``
        and ``_read_cold`` over ``disk_map``): hot rows gathered on the
        device into the output, the translated ids brought to the host
        (one synchronisation), and every row past the hot tier read from
        the disk tier into its position: through the prefetcher's ring
        where one is attached (its hits by one row gather on the ring,
        its misses from the file), else from the file. Where ``valid``
        (a device bool mask) is False the slot reads no disk row."""
        t = self._translate(ids, self.feature_order)
        if valid is not None:
            t = torch.where(valid, t, -1)
        out_dt = self._disk_dtype()
        if self.device_part is None:
            out = torch.zeros((ids.shape[0], self.dim()), dtype=out_dt,
                              device=self.device)
        else:
            out_dt = torch.promote_types(
                quant.tier_dtype(self.device_part), out_dt)
            out = self._gather_cached(self.device_part, t).to(out_dt)
        t_h = t.cpu().numpy()                  # the host path: one sync
        pos = np.flatnonzero(t_h >= self.cache_rows)
        if pos.size == 0:
            return out
        disk_rows = self.disk_map[t_h[pos]]
        pf = self._cold_prefetch
        if pf is not None:
            pf.gather(disk_rows, pos, out, self._dequant_disk)
            return out
        rows = self._dequant_disk(disk_rows)
        return out.index_copy_(0, torch.from_numpy(pos).to(self.device),
                               rows.to(self.device, out_dt))

    def getitem_masked(self, node_idx):
        """``feature[clip(ids)]`` with -1 ids giving zero rows. The call
        is the span ``feature.lookup`` (the tiered lookup's own)."""
        ids = self._ids(node_idx)
        if self._host_offload is not None and self.mmap_array is None:
            return self._lookup_tiered(self.device_part, self._host_offload,
                                       ids, self.feature_order, True)
        with tracing.span("feature.lookup"):
            return self._masked_untiered(ids)

    def _masked_untiered(self, ids):
        if self.host_part is None and self._host_offload is None \
                and self.mmap_array is None:
            return self._lookup_cached_masked(self.device_part, ids,
                                              self.feature_order)
        safe = ids.clamp(0, self.size(0) - 1)
        if self.mmap_array is not None:
            # a -1 slot reads no disk row (JAX reads node 0's for it)
            rows = self._lookup_disk(safe, valid=ids >= 0)
            return rows * (ids >= 0).to(rows.dtype)[:, None]
        rows = self[safe]
        return rows * (ids >= 0).to(rows.dtype)[:, None]

    def lookup_tiered(self, node_idx, masked: bool = False,
                      collect_metrics: bool = False):
        """``feature[ids]`` (``masked``: -1 ids give zero rows), or
        ``(rows, counters)`` with ``collect_metrics=True``: a
        ``[metrics.NUM_COUNTERS]`` int32 vector with the lookup's hot
        and cold rows (the observed hit rate) and, with ``dedup_cold``,
        the batch's duplicate statistics. The rows are the unmetered
        lookup's, bit for bit. An offload store and a store with no cold
        tier count on the card, without a host synchronisation; a
        ``host_placement="numpy"`` store, whose lookup goes through the
        host anyway, counts there and returns a CPU vector with the dup
        statistics only (``DEDUP_TOTAL``/``DEDUP_UNIQUE``: that path
        runs no compaction, so no dedup call or overflow is claimed), as
        JAX does. A disk store counts there too, and adds the prefetcher's
        slots: the ring hits and synchronous reads of this lookup, the
        rows staged and the IO facts since the last metered lookup
        (``PREFETCH_*``, ``IO_*``, ``STAGING_RESTARTS``); a masked
        lookup's -1 slots read no disk row and count in none of them,
        where JAX reads and counts node 0's row for each. The host path
        also takes the faults fired since the last metered lookup
        (``FAULTS_INJECTED``)."""
        if not collect_metrics:
            return self.getitem_masked(node_idx) if masked \
                else self[node_idx]
        ids = self._ids(node_idx)
        if self._host_offload is not None and self.mmap_array is None:
            col = metrics.Collector(self.device)
            rows = self._lookup_tiered(self.device_part, self._host_offload,
                                       ids, self.feature_order, masked, col)
            return rows, col.counters()
        pf = self._cold_prefetch
        pf_before = pf.counters() if pf is not None else None
        rows = self.getitem_masked(ids) if masked else self[ids]
        if self.host_part is None and self._host_offload is None \
                and self.mmap_array is None:
            # no cold tier: every valid slot is a hot-tier hit
            col = metrics.Collector(self.device)
            col.add(metrics.LOOKUP_CALLS, 1)
            col.add(metrics.HOT_ROWS, (ids >= 0).sum(dtype=torch.int32)
                    if masked else ids.shape[0])
            return rows, col.counters()
        ids_np = ids.cpu().numpy().astype(np.int64)
        valid = (ids_np >= 0) if masked else np.ones_like(ids_np, bool)
        order = self._order_host()
        if order is not None:
            t = order[np.clip(ids_np, 0, order.shape[0] - 1)]
        else:
            t = np.clip(ids_np, 0, max(self.size(0) - 1, 0))
        vec = np.zeros((metrics.NUM_COUNTERS,), np.int32)
        hot = int(((t < self.cache_rows) & valid).sum())
        vec[metrics.LOOKUP_CALLS] = 1
        vec[metrics.HOT_ROWS] = hot
        vec[metrics.COLD_ROWS] = int(valid.sum()) - hot
        n = int(ids_np.shape[0])
        if self.dedup_cold and _resolve_cold_budget(
                self.dedup_cold, self.cold_budget, n) < n:
            vec[metrics.DEDUP_TOTAL] = int(valid.sum())
            vec[metrics.DEDUP_UNIQUE] = int(np.unique(t[valid]).size)
        if pf_before is not None:
            # hits and sync reads are this lookup's (the prefetcher's
            # gather ran inside it, on this thread); staged rows and IO
            # facts are what the worker did since the last metered
            # lookup: a batch's publication runs during the previous step
            d = pf.counters() - pf_before
            vec[metrics.PREFETCH_HIT_ROWS] = int(d[0])
            vec[metrics.PREFETCH_SYNC_ROWS] = int(d[1])
            vec[metrics.PREFETCH_STAGED_ROWS] = pf.drain_staged()
            io = pf.drain_io()
            vec[metrics.IO_EXTENTS] = int(io[0])
            vec[metrics.IO_READ_ROWS] = int(io[1])
            vec[metrics.IO_READ_BYTES] = int(min(io[2], 2**31 - 1))
            vec[metrics.IO_DEPTH_PEAK] = int(io[3])
            vec[metrics.IO_RETRIES] = int(io[4])
            vec[metrics.STAGING_RESTARTS] = int(io[5])
        vec[metrics.FAULTS_INJECTED] = faults.drain_injected()
        return rows, torch.from_numpy(vec)

    # -- staging (JAX feature.py:767-796) ------------------------------------
    def prefetch(self, node_idx):
        """Start ``feature[node_idx]`` on the staging pipeline and return a
        ``concurrent.futures.Future`` whose ``result()`` equals it bit for
        bit. The pipeline has depth 2 (``submit`` blocks behind two
        queued lookups), keeps submission order, and is stopped by
        :meth:`close` (or when the store is collected).

        The ids are copied before this returns, so the caller may reuse
        their buffer. On the card the lookup runs on the worker's own
        stream after an event recorded on the caller's current stream
        (the ids' producer), and ``result()`` orders the reading stream
        after it (:class:`_StagedRows`): neither thread waits for the
        card, and the lookup itself makes no host synchronisation."""
        if self._pool is None:
            self._pool = Pipeline(depth=2, name="quiver-feature-prefetch",
                                  future_type=_StagedRows)
        ids = self._ids(node_idx).clone()
        if ids.device.type != "cuda":
            return self._pool.submit(self._staged, ids, None)
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(ids.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(ids.device))
        ids.record_stream(self._stage_stream)
        return self._pool.submit(self._staged, ids, ready)

    def _staged(self, ids, ready):
        """The worker's half of :meth:`prefetch`: ``(rows, done)``."""
        if ready is None:
            return self[ids], None
        stream = self._stage_stream
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            rows = self[ids]
            done = torch.cuda.Event()
            done.record(stream)
        return rows, done

    def close(self):
        """Stop the staging pipelines (idempotent): the pipeline of
        :meth:`prefetch` (the next ``prefetch`` starts a new one) and,
        when attached, the cold-tier prefetcher (detached). Without a
        call, each pipeline's ``weakref.finalize`` stops its worker when
        the store is collected."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()
        pf, self._cold_prefetch = self._cold_prefetch, None
        if pf is not None:
            pf.close()

    # -- cold-tier (disk) prefetch (JAX feature.py:928-976) -------------------
    def enable_cold_prefetch(self, capacity_rows: int = 65_536,
                             depth: int = 2, decode_staged: bool = True,
                             wait_inflight: bool = True,
                             workers: int = 1, io_qd: int = 16,
                             io_cap_bytes: int = 1 << 20,
                             io_engine: str = "auto", io_model=None):
        """Attach a frontier-keyed asynchronous prefetcher to the disk
        tier (:meth:`set_mmap_file` first): publish a future batch's
        frontier with :meth:`stage_frontier` (or drive the loop with
        ``async_sampler.sample_ahead``) and its disk reads overlap the
        current step; lookups read the staging ring first, a miss waits
        for a staging task still in flight (``wait_inflight``) and then
        reads the file, counted (``metrics.PREFETCH_SYNC_ROWS``), never
        wrong.

        ``capacity_rows`` ring slots (pinned on the card; decoded rows
        with ``decode_staged``, else an int8 tier's packed rows);
        ``depth`` publications in flight; ``workers`` staging workers
        shard each publication's unique rows, read as coalesced extents
        at queue depth ``io_qd`` of at most ``io_cap_bytes`` each by
        ``io.ExtentReader`` (``io_engine`` "auto" probes ``O_DIRECT``
        and falls back to buffered ``preadv``, "direct" and "pread"
        force one, "mmap" reads through the mmap; ``io_model`` is a
        ``StorageModel`` for tests). Returns the
        :class:`~quiver_tpu_torch.prefetch.ColdPrefetcher` (attaching
        again closes the previous one)."""
        if self.mmap_array is None or self.disk_map is None:
            raise ValueError("enable_cold_prefetch needs an mmap disk "
                             "tier (call set_mmap_file first)")
        from .prefetch import ColdPrefetcher
        if self._cold_prefetch is not None:
            self._cold_prefetch.close()
        self._order_host()          # the worker reads the host copy
        self._cold_prefetch = ColdPrefetcher(
            self, capacity_rows, depth=depth,
            decode_staged=decode_staged, wait_inflight=wait_inflight,
            workers=workers, io_qd=io_qd, io_cap_bytes=io_cap_bytes,
            io_engine=io_engine, io_model=io_model)
        return self._cold_prefetch

    def stage_frontier(self, node_idx):
        """Publish a future batch's frontier ids (-1 padding fine; card
        ids are copied to the host without blocking) to the cold-tier
        prefetcher. Returns the staging ``Future``, or None when no
        prefetcher is attached or it is saturated (the publication is
        dropped; the lookup then reads the file)."""
        pf = self._cold_prefetch
        if pf is None:
            return None
        return pf.publish(node_idx)

    # -- the disk tier (JAX feature.py:978-1106) ---------------------------
    def set_mmap_file(self, path, disk_map, scale=None, zero=None):
        """Attach the disk tier: ``path`` an ``.npy`` file of ``[rows,
        dim]`` rows (mmap'd, never loaded), ``disk_map`` a 1-D integer
        array (numpy or tensor) from storage row to file row spanning
        the whole logical id space (it defines ``shape[0]``; entries
        below ``cache_rows`` are never read), ``scale``/``zero`` (paths
        or arrays, ``[rows]`` or ``[rows, 1]``) the sidecars of an int8
        file, kept resident. Every row past the hot tier is then read
        from the file. Validated as JAX validates it, with its messages:
        a short map, cold entries outside the file, a width or dtype
        that contradicts the store, or one sidecar without the other
        raise. Attaching again closes an enabled prefetcher (its ring
        indexes the old file); call :meth:`enable_cold_prefetch` again
        after."""
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 2:
            raise ValueError(
                f"mmap feature file must be [rows, dim], got shape "
                f"{arr.shape}")
        dm = disk_map.detach().cpu().numpy() if torch.is_tensor(disk_map) \
            else np.asarray(disk_map)
        if dm.ndim != 1 or not np.issubdtype(dm.dtype, np.integer):
            raise ValueError(
                "disk_map must be a 1-D integer array mapping storage "
                f"row -> mmap row, got shape {dm.shape} dtype {dm.dtype}")
        if dm.shape[0] < self.cache_rows:
            raise ValueError(
                f"disk_map has {dm.shape[0]} entries but the HBM tier "
                f"already holds {self.cache_rows} rows — the map must "
                "span the full logical id space (it defines shape[0])")
        cold = dm[self.cache_rows:]
        bad = int(((cold < 0) | (cold >= arr.shape[0])).sum())
        if bad:
            raise ValueError(
                f"{bad} disk_map entries in the cold region (storage "
                f"rows >= {self.cache_rows}) fall outside the mmap's "
                f"{arr.shape[0]} rows — negative entries wrap in numpy "
                "fancy indexing and would gather garbage rows silently")
        dim = None
        for tier in (self.device_part, self.host_part, self._host_offload):
            if tier is not None:
                dim = quant.tier_dim(tier)
                break
        if dim is not None and arr.shape[1] != dim:
            raise ValueError(
                f"mmap rows are {arr.shape[1]} wide but the store's "
                f"resident tiers are {dim} wide")
        ds, dz = _load_sidecar(scale), _load_sidecar(zero)
        if (ds is None) != (dz is None):
            raise ValueError("quantized disk tier needs BOTH scale and "
                             "zero sidecars")
        if ds is not None:
            ds = ds[:, None] if ds.ndim == 1 else ds
            dz = dz[:, None] if dz.ndim == 1 else dz
            want = (arr.shape[0], 1)
            if tuple(ds.shape) != want or tuple(dz.shape) != want:
                raise ValueError(
                    f"scale/zero sidecars must be [rows, 1] aligned "
                    f"with the mmap ({want}), got {tuple(ds.shape)} / "
                    f"{tuple(dz.shape)}")
            if arr.dtype != np.int8:
                raise ValueError(
                    "scale/zero sidecars mark an int8-quantized tier "
                    f"but the mmap dtype is {arr.dtype}")
        else:
            if arr.dtype == np.int8:
                raise ValueError(
                    "int8 mmap without scale/zero sidecars would be "
                    "returned as raw codes — pass the sidecars (or "
                    "store the file dequantized)")
            if self.dtype_policy["cold"] == "int8":
                raise ValueError(
                    "store's cold dtype policy is int8 but the mmap "
                    f"tier is un-sidecar'd {arr.dtype} — quantize the "
                    "file (partition.save_disk_tier) or drop the policy")
        self.mmap_array = arr
        self.disk_map = dm.astype(np.int64, copy=False)
        self.disk_scale = ds
        self.disk_zero = dz
        if self._cold_prefetch is not None:
            self._cold_prefetch.close()
            self._cold_prefetch = None

    def _disk_dtype(self) -> torch.dtype:
        """The dtype of the disk tier's decoded rows."""
        src = self.mmap_array if self.disk_scale is None else self.disk_scale
        return quant.torch_dtype(src.dtype)

    def _dequant_disk(self, disk_rows: np.ndarray) -> torch.Tensor:
        """File rows ``disk_rows`` read through the mmap and decoded
        (``quant.decode_np``), as a CPU tensor."""
        rows = np.asarray(self.mmap_array[disk_rows])
        if self.disk_scale is not None:
            rows = quant.decode_np(rows, self.disk_scale[disk_rows],
                                   self.disk_zero[disk_rows])
        return torch.from_numpy(rows)

    def read_mmap(self, ids):
        """File rows ``ids`` (file row ids, not node ids), decoded, as a
        CPU tensor: the disk tier's plain read."""
        if self.mmap_array is None:
            raise ValueError("read_mmap needs an mmap disk tier (call "
                             "set_mmap_file first)")
        ids = ids.detach().cpu().numpy() if torch.is_tensor(ids) \
            else np.asarray(ids)
        return self._dequant_disk(ids)

    def set_local_order(self, local_order):
        """Take node ids through a node-local order (reference
        feature.py:283-294): ``local_order[r]`` is the node stored at row
        ``r``, and ``feature_order`` becomes its inverse."""
        lo = local_order.detach().cpu().numpy() \
            if torch.is_tensor(local_order) else np.asarray(local_order)
        lo = lo.astype(np.int64).reshape(-1)
        order = np.zeros(lo.shape[0], np.int32)
        order[lo] = np.arange(lo.shape[0], dtype=np.int32)
        self.feature_order = torch.from_numpy(order).to(self.device)
        self._order_np = (self.feature_order, order)

    def _order_host(self) -> Optional[np.ndarray]:
        """Host copy of ``feature_order``, cached by the tensor's
        identity (a rotation or a new order makes a new tensor)."""
        if self.feature_order is None:
            return None
        if self._order_np is None \
                or self._order_np[0] is not self.feature_order:
            self._order_np = (self.feature_order,
                              self.feature_order.cpu().numpy())
        return self._order_np[1]

    # -- process sharing (reference feature.py:335-398) ----------------------
    def share_ipc(self):
        """JAX's tuple ``(rank, device_list, device_cache_size,
        cache_policy, csr_topo, state)`` (``feature.py:1177-1190``), whose
        last item is the store as a ``torch.multiprocessing`` worker
        receives it: its device tiers (a clique's blocks included) are
        sent by torch's CUDA IPC reductions, and its cold tier as shared
        host memory. A pinned cold tier is moved into shared pages once,
        here, and registered with CUDA in its place
        (``utils.placement.share_host``: torch cannot share a pinned
        allocation), so host residency stays 1x; each worker registers
        its own mapping again (:meth:`new_from_ipc_handle`), and its
        gathers read pinned pages, never a pageable copy. Send the tuple
        to the worker through a ``torch.multiprocessing`` queue or as a
        spawn argument; after ``import quiver_tpu_torch.multiprocessing``
        the store itself pickles this way. A store with a disk tier is
        refused (attach its file in the worker)."""
        if self.mmap_array is not None:
            raise ValueError("share_ipc cannot send a disk-tier store: "
                             "call set_mmap_file in the worker")
        if self._host_offload is not None:
            self._host_offload = share_host(self._host_offload, self.device)
        elif self.host_part is not None:
            self.host_part = share_host(self.host_part, torch.device("cpu"))
        state = dict(self.__dict__)
        state["_pool"] = state["_stage_stream"] = None
        state["_cold_prefetch"] = state["_order_np"] = None
        return (self.rank, self.device_list, self.device_cache_size,
                self.cache_policy, self.csr_topo, state)

    @classmethod
    def lazy_from_ipc_handle(cls, ipc_handle) -> "Feature":
        """The store of a :meth:`share_ipc` handle, its tiers not yet
        opened for this process: call :meth:`lazy_init_from_ipc_handle`
        before the first lookup."""
        store = cls.__new__(cls)
        store.__dict__.update(ipc_handle[-1])
        return store

    def lazy_init_from_ipc_handle(self) -> "Feature":
        """Open a store made by :meth:`lazy_from_ipc_handle` in this
        process: pin its shared cold tier for the card and build a
        clique's gather table (peer access enabled). Returns it."""
        host = self._host_offload
        if host is not None:
            register_host(host, self.device)
        if quant.is_sharded(self.device_part):
            if self.device.type == "cuda":
                init_p2p(self.device_part.block_devices())
            prepare_sharded(self.device_part)
        return self

    @classmethod
    def new_from_ipc_handle(cls, rank, ipc_handle) -> "Feature":
        """A working store in a ``torch.multiprocessing`` worker from a
        :meth:`share_ipc` handle: the parent's tiers, opened here (no row
        is copied). ``rank`` is kept as the store's rank."""
        store = cls.lazy_from_ipc_handle(ipc_handle)
        store.rank = rank
        return store.lazy_init_from_ipc_handle()

    # -- online hot-set rotation ----------------------------------------------
    def rotate_hot_set(self, promote, demote):
        """Swap ``demote`` (hot nodes) out of the hot tier for
        ``promote`` (cold nodes), online: the stored bytes of each row
        (codes and sidecars of an int8 tier) move between the tiers
        as they are, and ``feature_order`` swaps the two nodes' storage
        rows, so every lookup gives the same bits before and after.

        The hot tier and ``feature_order`` become new tensors (the old
        ones are not written, so an engine still holding them keeps
        serving the store as it was); the host tier is updated in place,
        as in JAX. A ``ServeEngine`` built over this store serves its
        own copy of the tiers until ``engine.refresh_feature()``.

        Refused (``ValueError``, nothing moved) without a
        ``feature_order``, without a hot tier, without a
        ``host_placement="numpy"`` host tier (an offload tier is pinned
        as it was built; a disk store adapts through ``stage_frontier``
        instead), over a sharded hot tier (JAX's message: it would need
        a cross-device scatter), with different hot and cold dtype
        policies (a
        row would be re-encoded), with ``promote``/``demote`` not
        pairing 1:1 as unique ids, out of range, or not currently cold
        and hot. Returns ``{"rotated": k}``."""
        if self.feature_order is None:
            raise ValueError(
                "rotate_hot_set needs a hot-order store (feature_order "
                "is None — construct with a csr_topo or set_local_order)")
        if not self.cache_rows or self.device_part is None:
            raise ValueError("rotate_hot_set needs a non-empty hot tier")
        if self.host_part is None or self.mmap_array is not None:
            raise ValueError(
                "rotate_hot_set needs a numpy host tier (disk/mmap "
                "stores promote through stage_frontier; offloaded cold "
                "tiers are pinned immutably)")
        if self.cache_policy != "device_replicate" and self._mesh_size() > 1:
            raise ValueError(
                "rotate_hot_set supports replicated hot tiers only "
                "(a row-sharded tier would need a cross-device scatter)")
        if self.dtype_policy["hot"] != self.dtype_policy["cold"]:
            raise ValueError(
                f"rotate_hot_set needs identical hot/cold dtype "
                f"policies (got {self.dtype_policy!r}); rows crossing "
                "tiers would re-encode and break bit-identity")
        promote = np.unique(_cpu_tensor(promote).numpy().astype(np.int64)
                            .reshape(-1))
        demote = np.unique(_cpu_tensor(demote).numpy().astype(np.int64)
                           .reshape(-1))
        if promote.size != demote.size:
            raise ValueError(
                f"promote/demote must pair 1:1, got {promote.size} vs "
                f"{demote.size} unique ids")
        if promote.size == 0:
            return {"rotated": 0}
        order = self._order_host().astype(np.int64)
        n = order.shape[0]
        for ids, what in ((promote, "promote"), (demote, "demote")):
            if ids[0] < 0 or ids[-1] >= n:
                raise ValueError(f"{what} ids out of range [0, {n})")
        rp = order[promote]            # storage rows, must be cold
        rd = order[demote]             # storage rows, must be hot
        if not (rp >= self.cache_rows).all():
            raise ValueError("promote ids must currently be cold rows")
        if not (rd < self.cache_rows).all():
            raise ValueError("demote ids must currently be hot rows")
        rd_dev = torch.from_numpy(rd).to(self.device)
        host_rows = torch.from_numpy(rp - self.cache_rows)
        new_dev = []
        for dl, hl in zip(quant.tier_parts(self.device_part),
                          quant.tier_parts(self.host_part)):
            if dl is None:
                continue
            down = dl.index_select(0, rd_dev).cpu()
            up = hl.index_select(0, host_rows).to(self.device)
            new_dev.append(dl.clone().index_copy_(0, rd_dev, up))
            hl.index_copy_(0, host_rows, down)
        self.device_part = quant.QuantizedTensor(*new_dev) \
            if quant.is_quantized(self.device_part) else new_dev[0]
        order[promote] = rd
        order[demote] = rp
        self.feature_order = torch.from_numpy(order).to(self.device,
                                                        torch.int32)
        return {"rotated": int(promote.size)}

    # -- pickling ------------------------------------------------------------
    def __getstate__(self):
        """The store's state with every tensor on the CPU: a pinned
        offload tier goes out as a plain CPU copy (unpacked) in
        ``host_part`` and is pinned again on load; a clique's hot tier
        goes out as its rows and is sharded again on load. A disk tier goes out
        as its rows (the mmap pickles as an array, as in JAX) without its
        prefetcher: threads do not pickle, and a loaded store reads the
        file rows synchronously until ``enable_cold_prefetch``."""
        state = dict(self.__dict__)
        state["_host_offload"] = None
        state["_pool"] = state["_stage_stream"] = None
        state["_cold_prefetch"] = state["_order_np"] = None
        if self._host_offload is not None:
            state["host_part"] = quant.tree_map_tier(
                lambda t: torch.empty(t.shape, dtype=t.dtype).copy_(t),
                self._host_offload)
        if self.sharded:
            # a clique's blocks go out as the hot rows, re-sharded on load
            state["device_part"] = quant.tree_map_tier(
                lambda t: t[:self.cache_rows],
                self.device_part.unsharded())
        for k in ("device_part", "feature_order"):
            if state[k] is not None:
                state[k] = quant.tree_map_tier(torch.Tensor.cpu, state[k])
        return state

    def __setstate__(self, state):
        """Device tensors return to the store's device (the card unless
        it was the CPU; with no card, loading a card's store raises); an
        offload tier is pinned again. Pickles without ``cold_budget``,
        ``dedup_cold`` or ``dtype_policy`` load with their defaults."""
        self.__dict__.update(state)
        self.__dict__.setdefault("cold_budget", None)
        self.__dict__.setdefault("dedup_cold", False)
        self.__dict__.setdefault("dtype_policy", {"hot": None, "cold": None})
        for k in ("_pool", "_stage_stream", "mmap_array", "disk_map",
                  "disk_scale", "disk_zero", "_cold_prefetch", "_order_np"):
            self.__dict__.setdefault(k, None)
        self.__dict__.setdefault("mesh", None)
        self.device = resolve_device(self.device)
        if self.feature_order is not None:
            self.feature_order = self.feature_order.to(self.device)
        if self.device_part is not None:
            self._place(self.device_part)
        self._host_offload = None
        self._maybe_offload_host()

    # -- shape protocol ------------------------------------------------------
    @property
    def shape(self):
        cold = self.host_part if self.host_part is not None \
            else self._host_offload
        if self.disk_map is not None:
            # the disk map spans the whole logical id space
            rows = int(self.disk_map.shape[0])
        else:
            rows = self.cache_rows + (0 if cold is None
                                      else quant.tier_rows(cold))
        dim = None
        for tier in (self.device_part, cold, self.mmap_array):
            if tier is not None:
                dim = quant.tier_dim(tier)
                break
        return (rows, dim)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def dim(self) -> int:
        return self.shape[1]


# -- the partitioned store across ranks --------------------------------------


class ExchangeCapPlan(NamedTuple):
    """Degree-mass-aware sizing of the compact exchange's per-owner
    request slots (the ``exchange_cap`` knob)."""

    cap: int             # per-owner request slots ([H, cap] block)
    unique_budget: int   # cap * hosts: the compact unique table's size
    owner_frac: float    # the heaviest owner's expected request share
    balanced_cap: int    # the ownership-blind sizing, for the log


class PartitionInfo:
    """Placement across hosts (reference feature.py:461-526):
    ``global2host`` maps node -> owning host, ``replicate`` (optional)
    lists the nodes every host also keeps at the tail of its shard, and
    ``global2local`` maps node -> row on its owner (a replicated node:
    its row in *this* host's tail). The maps are int32 CPU tensors;
    ``device`` is taken for the reference's signature, and a
    ``DistFeature`` copies the maps to its own device."""

    def __init__(self, device=None, host: int = 0, hosts: int = 1,
                 global2host=None, replicate=None):
        self.host = host
        self.hosts = hosts
        self.global2host = torch.as_tensor(
            quant._host(global2host).astype(np.int32))
        self.replicate = None if replicate is None else torch.as_tensor(
            quant._host(replicate).astype(np.int32))
        self.node_count = int(self.global2host.shape[0])
        self._init_global2local()

    def _init_global2local(self):
        g2h = self.global2host.numpy()
        g2l = np.zeros(self.node_count, dtype=np.int32)
        self.local_sizes = []
        for h in range(self.hosts):
            owned = np.flatnonzero(g2h == h)
            g2l[owned] = np.arange(owned.size, dtype=np.int32)
            self.local_sizes.append(int(owned.size))
        if self.replicate is not None:
            rep = self.replicate.numpy()
            base = self.local_sizes[self.host]
            g2l[rep] = base + np.arange(rep.size, dtype=np.int32)
        self.global2local = torch.from_numpy(g2l)

    def plan_exchange_cap(self, frontier_cap: int, degree=None,
                          dup_factor: float = 8.0,
                          slack: float = 1.25) -> ExchangeCapPlan:
        """Size the compact exchange's per-owner request slots from this
        partition's skew: a frontier of ``frontier_cap`` slots holds about
        ``frontier_cap / dup_factor`` distinct ids, and each owner's share
        of them follows its nodes' degree mass (``degree``) or, without
        degrees, its node count. ``cap`` is the heaviest owner's expected
        load with ``slack`` headroom; pass it as ``exchange_cap``. An
        overflow costs no correctness (the dense exchange takes over),
        only the traffic bound."""
        uniq = max(int(frontier_cap / max(dup_factor, 1.0)), self.hosts)
        g2h = self.global2host.numpy()
        if degree is not None:
            deg = quant._host(degree).astype(np.float64)
            mass = np.zeros(self.hosts, np.float64)
            np.add.at(mass, g2h, deg[:g2h.shape[0]])
        else:
            mass = np.bincount(g2h, minlength=self.hosts).astype(
                np.float64)
        frac = float(mass.max() / (mass.sum() or 1.0))
        frac = max(frac, 1.0 / self.hosts)
        cap = min(cap_for_expected_load(uniq * frac, slack),
                  int(frontier_cap))
        balanced = cap_for_expected_load(uniq / self.hosts, slack)
        return ExchangeCapPlan(cap, cap * self.hosts, frac, balanced)

    def dispatch(self, ids):
        """Split request ids per owning host; replicated ids resolve
        locally. Returns (per-host local-row arrays, per-host positions),
        numpy."""
        ids_np = quant._host(ids).astype(np.int64)
        g2h = self.global2host.numpy()
        g2l = self.global2local.numpy()
        owner = g2h[ids_np]
        if self.replicate is not None:
            rep = np.zeros(self.node_count, bool)
            rep[self.replicate.numpy()] = True
            owner = np.where(rep[ids_np], self.host, owner)
        host_ids, host_pos = [], []
        for h in range(self.hosts):
            pos = np.flatnonzero(owner == h)
            host_ids.append(g2l[ids_np[pos]])
            host_pos.append(pos)
        return host_ids, host_pos


class DistFeature:
    """Cross-host feature lookup (reference feature.py:529-567):
    dispatch, exchange, local read, scatter.

    Two modes:
    - **process group** (:meth:`from_partition`, a ``comm`` with a
      group): each rank holds its own shard and ``dist[ids]`` takes this
      rank's ``[B]`` ids (-1 fill) and runs ``comm.dist_lookup_local``,
      the ``all_to_all`` exchange; every rank of the group looks up
      together, with the same ``B``. Rank ``h`` gets slice ``h`` of what
      the JAX package's ``dist[ids]`` returns for the ``[H*B]``
      concatenation;
    - **local/peers** (a ``Feature`` and ``comm.peers``): host-driven
      dispatch for single-process tests of the protocol, as in JAX; not
      a production path.

    ``dedup_cold`` (True, or an int budget of the whole group's batch,
    as in JAX) runs the exchange over each rank's unique ids (a table of
    ``budget / H`` per rank, default ``max(H*B // 4, H)`` rounded up to
    a multiple of ``H``) and expands them back; when any rank's unique
    count overflows, every rank looks up the whole batch instead (one
    ``all_reduce(MAX)`` and one ``.item()``, the JAX path's one scalar
    synchronisation). ``exchange_cap`` (``True | int | None``) compacts
    the exchange itself (``comm.dist_lookup_local``); True sizes it per
    batch (``comm.default_exchange_cap``), an int pins it (prefer
    ``info.plan_exchange_cap(...).cap``). ``collect_metrics`` puts each
    lookup's device counters on ``last_counters`` (this rank's ``[1,
    N]`` block, or with ``merge_counters`` the group's ``[N]`` vector,
    merged on the device). Rows are the same bits with any of these."""

    def __init__(self, feature: Optional[Feature], info: PartitionInfo,
                 comm, dedup_cold=False, exchange_cap=None,
                 collect_metrics=False, merge_counters=False):
        self.feature = feature
        self.info = info
        self.comm = comm
        self.dedup_cold = dedup_cold
        self.exchange_cap = exchange_cap
        self.collect_metrics = bool(collect_metrics)
        self.merge_counters = bool(merge_counters)
        if self.merge_counters and not self.collect_metrics:
            raise ValueError("merge_counters=True requires "
                             "collect_metrics=True")
        self.last_counters = None
        self.shard = None              # this rank's [rows_per_host, dim]
        self.device = None if feature is None else feature.device
        self._rows_per_host = None
        self._g2h = self._g2l = None
        self._rep_args = None
        self._lookup_fns = {}

    @classmethod
    def from_partition(cls, feat, info: PartitionInfo, comm, dtype=None,
                       dedup_cold=False, dtype_policy=None,
                       exchange_cap=None, collect_metrics=False,
                       merge_counters=False, device=None) -> "DistFeature":
        """This rank's store from the full feature array (numpy or a
        tensor on any device) and the placement: the rows the partition
        gives rank ``comm.rank``, then the replicated nodes' rows (its
        tail), zero-padded to ``rows_per_host``, the largest shard over
        the ranks, so every rank's block has one shape. The shard lies on
        ``device`` (the card unless ``"cpu"``).

        ``dtype`` casts the rows first; ``dtype_policy`` ("bf16", "fp16",
        "int8") stores them narrow and the exchange ships them narrow: an
        int8 shard lies in packed rows (``quant.pack``) that cross the
        wire as they are and are decoded after it."""
        if comm.group is None:
            raise ValueError("from_partition needs a comm with a process "
                             "group")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        feat = feat.to(dev) if torch.is_tensor(feat) else \
            torch.as_tensor(np.asarray(feat), device=dev)
        if dtype is not None:
            feat = feat.to(quant.torch_dtype(dtype))
        g2h = info.global2host.numpy()
        rep = None if info.replicate is None else info.replicate.numpy()
        rep_rows = 0 if rep is None else rep.size
        rows_per_host = max(s + rep_rows for s in info.local_sizes)
        rows = np.flatnonzero(g2h == comm.rank)
        if rep is not None:
            rows = np.concatenate([rows, rep])
        store = torch.zeros((rows_per_host, feat.shape[1]),
                            dtype=feat.dtype, device=dev)
        store[:rows.size] = feat[torch.as_tensor(rows, device=dev)]
        self = cls(None, info, comm, dedup_cold=dedup_cold,
                   exchange_cap=exchange_cap,
                   collect_metrics=collect_metrics,
                   merge_counters=merge_counters)
        shard = quant.quantize(store, quant.resolve_policy(dtype_policy))
        if quant.is_quantized(shard):
            shard = quant.pack(shard, device=dev)
        self.shard = shard
        self.device = dev
        self._rows_per_host = rows_per_host
        self._g2h = info.global2host.to(dev)
        self._g2l = info.global2local.to(dev)
        if rep is not None:
            n = info.node_count
            is_rep = torch.zeros(n, dtype=torch.bool)
            is_rep[torch.as_tensor(rep).long()] = True
            rep_rank = torch.zeros(n, dtype=torch.int32)
            rep_rank[torch.as_tensor(rep).long()] = torch.arange(
                rep_rows, dtype=torch.int32)
            bases = torch.tensor(info.local_sizes, dtype=torch.int32)
            self._rep_args = tuple(t.to(dev) for t in
                                   (is_rep, rep_rank, bases))
        return self

    def _ids(self, ids) -> torch.Tensor:
        t = ids if torch.is_tensor(ids) else torch.as_tensor(np.asarray(ids))
        return t.reshape(-1).to(device=self.device, dtype=torch.int32)

    def _getitem_dedup(self, ids):
        """The exchange over this rank's unique ids, expanded back; None
        when the table cannot help (its budget reaches the batch) or a
        rank's unique count overflows it. The int32-max fill of the
        table reads the last node's row, and the batch's -1 padding
        dedups to one zero row, as in JAX."""
        hosts = self.info.hosts
        n = ids.shape[0] * hosts
        budget = (int(self.dedup_cold)
                  if not isinstance(self.dedup_cold, bool)
                  else max(n // 4, hosts))
        budget = min(-(-budget // hosts) * hosts, n)
        if budget >= n:
            return None
        uniq, inv, n_uniq = unique_within_budget(ids, budget // hosts)
        over = (n_uniq > budget // hosts).to(torch.int32).reshape(1)
        dist.all_reduce(over, op=dist.ReduceOp.MAX, group=self.comm.group)
        if over.item():
            return None
        return gather_rows(self._getitem_plain(uniq), inv)

    def _getitem_plain(self, ids):
        b = ids.shape[0]
        cap = self.exchange_cap
        if cap is True:
            cap = default_exchange_cap(b, self.info.hosts)
        elif cap is not None:
            cap = int(cap)
        key = (b, cap, self.collect_metrics, self.merge_counters)
        fn = self._lookup_fns.get(key)
        if fn is None:
            fn = build_dist_lookup_fn(
                self.comm.group, self._rows_per_host, b,
                with_replicate=self._rep_args is not None,
                exchange_cap=cap, collect_metrics=self.collect_metrics,
                merge_counters=self.merge_counters)
            self._lookup_fns[key] = fn
        args = (ids, self._g2h, self._g2l, self.shard)
        if self._rep_args is not None:
            args += self._rep_args
        if self.collect_metrics:
            out, self.last_counters = fn(*args)
            return out
        return fn(*args)

    def __getitem__(self, ids):
        if self.shard is not None:
            ids = self._ids(ids)
            if self.dedup_cold:
                out = self._getitem_dedup(ids)
                if out is not None:
                    return out
            return self._getitem_plain(ids)
        host_ids, host_pos = self.info.dispatch(ids)
        my = self.info.host
        n = int(quant._host(ids).reshape(-1).shape[0])
        local_rows = self.feature[torch.as_tensor(host_ids[my])] \
            if host_ids[my].size else None
        remote = self.comm.exchange(host_ids, self.feature)
        dtype = local_rows.dtype if local_rows is not None \
            else torch.float32
        out = torch.zeros((n, self.feature.shape[1]), dtype=dtype,
                          device=self.feature.device)
        if local_rows is not None:
            out[torch.as_tensor(host_pos[my])] = local_rows.to(dtype)
        for h, rows in enumerate(remote):
            if rows is not None and host_pos[h].size:
                out[torch.as_tensor(host_pos[h])] = rows.to(out.device,
                                                            dtype)
        return out
