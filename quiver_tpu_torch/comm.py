"""Cross-rank communication over ``torch.distributed`` (counterpart of
``quiver_tpu/comm.py``).

The JAX package runs one controller over a mesh and puts its collectives
inside ``shard_map``. The port runs the reference's way: one process per
rank in a ``torch.distributed`` process group (NCCL between cards, gloo
on the CPU), each running the per-shard body of the JAX package as its
own code, each collective a call:

  ``lax.all_to_all(x, split_axis=0, concat_axis=0)`` ->
      ``all_to_all_single`` over equal dim-0 chunks
  ``lax.pmax(flag)`` -> ``all_reduce(flag, MAX)``
  ``lax.axis_index(axis)`` -> ``get_rank(group)``

Where JAX takes the ``[H*B]`` concatenation of every host's ids, a rank
passes its own ``[B]`` and gets back rank ``h``'s slice of JAX's output.
Every block crosses the wire as bytes (a ``uint8`` view of the same
memory), so each backend moves every dtype the store holds.

The exchange (:func:`dist_lookup_local`) buckets a rank's ids by owner,
ships the request block, and the owner reads the requested rows of its
shard with the CUDA row gather (``ops/kernels/gather.py``, the
counterpart of the Pallas ``_gather_kernel``; a second use of that
kernel, never ``index_select``); the response block comes back and one
more ``gather_rows`` launch puts the rows in batch order, zero rows at
-1 ids. An int8 shard lies in packed rows (``quant.pack``: codes, fp32
scale and zero in one row, 128 bytes at width 100), which cross the wire
as they are; the second launch is then the packed gather, which decodes
as it puts the rows in order. The wire carries 128 bytes a row at width
100 where JAX ships 108.

The compact exchange picks its branch on the host: the two branches move
blocks of different sizes, so every rank must know which one runs before
its first collective. One ``int32`` ``all_reduce(MAX)`` of the overflow
flag and one ``.item()`` decide it, the same on every rank (a rank that
took the other branch would wait forever in a collective that its peers
never enter). The dense lookup makes no host synchronisation.

``HostRankTable`` and ``schedule`` are the reference's host-side rank
bookkeeping and pairwise schedule, copied from the JAX package.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import metrics
from .ops import quant
from .ops.dedup import I32_MAX, unique_within_budget
from .ops.kernels.gather import gather_rows, packed_row_stride


def get_comm_id() -> bytes:
    """Shim for the reference's ``quiver.getNcclId``: the process
    group's rendezvous (``init_method``) replaces the id; nothing to
    mint."""
    return b"quiver-tpu-comm"


def init_distributed(backend: str = "nccl", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[float] = None):
    """Join the default process group (the reference's NcclId and
    TCPStore rendezvous): ``backend`` ``"nccl"`` for ranks on cards,
    ``"gloo"`` for ranks on the CPU; ``init_method`` a
    ``tcp://host:port`` or ``file://path`` rendezvous (None reads the
    environment, as ``torch.distributed`` does); ``timeout`` in seconds
    bounds every collective, so a rank that waits for a dead or diverged
    peer raises instead of hanging. An NCCL group binds the current
    card. Returns the group."""
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return dist.group.WORLD


class HostRankTable:
    """(host, lane) <-> global rank mapping (reference comm.py:5-39)."""

    def __init__(self, hosts: int, rank_per_host: int):
        self.hosts = hosts
        self.rank_per_host = rank_per_host
        self.world_size = hosts * rank_per_host

    def rank(self, host: int, lane: int) -> int:
        return host * self.rank_per_host + lane

    def host_lane(self, rank: int):
        return divmod(rank, self.rank_per_host)

    def ranks_of_host(self, host: int) -> List[int]:
        base = host * self.rank_per_host
        return list(range(base, base + self.rank_per_host))


def schedule(size_matrix) -> List[List[tuple]]:
    """Greedy contention-free step packing of pairwise transfers
    (reference comm.py:42-75): given a ws x ws byte matrix, emit steps
    where no rank appears twice, biggest first."""
    sizes = np.array(size_matrix, dtype=np.int64, copy=True)
    ws = sizes.shape[0]
    np.fill_diagonal(sizes, 0)
    steps: List[List[tuple]] = []
    while sizes.any():
        busy = set()
        step = []
        order = np.argsort(sizes, axis=None)[::-1]
        for flat in order:
            src, dst = divmod(int(flat), ws)
            if sizes[src, dst] == 0 or src in busy or dst in busy:
                continue
            step.append((src, dst))
            busy.add(src)
            busy.add(dst)
            sizes[src, dst] = 0
        steps.append(step)
    return steps


def cap_for_expected_load(per_owner: float, slack: float = 1.25) -> int:
    """The compact exchange's cap for an expected per-owner
    unique-request load: ``slack`` proportional headroom plus ~3-sigma
    binomial headroom (the JAX package's one formula, shared by
    :func:`default_exchange_cap` and ``PartitionInfo.plan_exchange_cap``)."""
    return max(1, int(np.ceil(slack * per_owner
                              + 3.0 * np.sqrt(max(per_owner, 0.0)))))


def default_exchange_cap(batch: int, hosts: int, slack: float = 1.25) -> int:
    """Per-owner request slots of the compact exchange without partition
    statistics: a duplicate factor of at least 8 on a multi-hop frontier
    and balanced ownership, with ``slack`` headroom. Callers with a
    partition should prefer ``PartitionInfo.plan_exchange_cap``."""
    uniq = max(batch // 8, hosts)
    return min(batch, cap_for_expected_load(uniq / hosts, slack))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` over equal dim-0 chunks (chunk
    ``d`` to rank ``d``, the received chunk of rank ``s`` at position
    ``s``), carried as a ``uint8`` view so every dtype crosses every
    backend."""
    x = x.contiguous()
    wire = x.view(torch.uint8)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.view(x.dtype)


def _wire_table(feat) -> torch.Tensor:
    """The rows an owner ships: a plain shard as it is; an int8 shard as
    its packed rows, an int8 ``[N, stride]`` table. An int8 shard must
    already lie in packed rows."""
    if not quant.is_quantized(feat):
        return feat
    stride = packed_row_stride(feat)
    if stride is None:
        raise ValueError(
            "an int8 shard crosses the exchange in packed rows: pack it "
            "once with quant.pack(shard, device=...), or build the store "
            "with DistFeature.from_partition")
    data = feat.data
    return data.as_strided((data.shape[0], stride), (stride, 1))


def _unwire(resp: torch.Tensor, idx: torch.Tensor, feat) -> torch.Tensor:
    """Rows ``resp[idx[i]]`` of the received block in the caller's
    order, +0.0 rows where ``idx`` is -1: one ``gather_rows`` launch,
    which decodes an int8 block's packed rows as it reads them."""
    dim = quant.tier_dim(feat)
    if quant.is_quantized(feat):
        resp = quant.packed_views(resp.view(torch.uint8), dim)
    out = torch.zeros((idx.shape[0], dim), dtype=quant.tier_dtype(feat),
                      device=idx.device)
    return gather_rows(resp, idx, out=out)


def dist_lookup_local(ids: torch.Tensor, g2h: torch.Tensor,
                      loc: torch.Tensor, feat, group, h_count: int,
                      rows_per_host: int, dtype=None, rep=None,
                      exchange_cap: Optional[int] = None, collector=None):
    """One rank's DistFeature lookup (the per-shard body of the JAX
    function); every rank of ``group`` calls it together:

      ids  [B] this rank's global node ids, -1 fill
      g2h/loc [N] owner / local-row maps, the same on every rank
      feat [rows_per_host, dim] this rank's shard: a tensor, or an int8
           ``QuantizedTensor`` in packed rows (``quant.pack``)
      -> [B, dim] rows (+0.0 at -1 fill), in the store's dequantized
         dtype unless ``dtype`` is given

    Route each id to its owner and local row (``rep`` = ``(is_rep [N],
    rep_rank [N], bases [H])`` resolves replicated nodes against this
    rank's replica tail), bucket by owner (one-hot and ``cumsum``, the
    JAX package's slot positions bit for bit) into an ``[H, B]`` request
    block, ship it by ``all_to_all``, read the requested rows of the
    shard (``gather_rows``), ship them back, and put them in batch order
    (``gather_rows`` again; the int8 decode happens there, after the
    exchange).

    ``exchange_cap`` (None = dense) takes the compact path: the ids
    dedup into a ``min(cap * H, B)`` table (``unique_within_budget``),
    the unique ids bucket into an ``[H, cap]`` block, and the wire
    carries ``[H, cap]`` requests and rows. When the unique count
    overflows the table or an owner's bucket overflows ``cap`` on any
    rank, every rank takes the dense path: the flag is reduced by
    ``all_reduce(MAX)`` and read on the host once (the port's one host
    synchronisation per compact lookup). Rows are the same bits either
    way.

    ``collector`` (a ``metrics.Collector``) records what the JAX
    function records: ``EXCH_CALLS``; on the dense path the peak bucket
    load; on the compact path the dedup statistics, the reduced
    fallback flag, the peak bucket load and the cap, all before the
    branch."""
    dev = ids.device
    ids = ids.to(torch.int32)
    batch = ids.shape[0]
    valid = ids >= 0
    n_nodes = g2h.shape[0]
    me = dist.get_rank(group)

    def route(ids_, valid_):
        """Global id -> (owner, local row); -1 owner at invalid slots,
        which then match no bucket. Clips from above too: the compact
        path's unique table carries int32-max fill."""
        safe = ids_.clamp(0, n_nodes - 1).long()
        owner = torch.where(valid_, g2h[safe], -1)
        local = loc[safe]
        if rep:
            is_rep, rep_rank, bases = rep
            r = is_rep[safe]
            owner = torch.where(valid_ & r, me, owner)
            local = torch.where(r, bases[me] + rep_rank[safe], local)
        return owner, local

    def bucket(owner, local, valid_, cap_):
        """The ``[H * cap_]`` request block (owner-major), each valid
        id's position in its owner's bucket, and each owner's load.
        Positions at or past ``cap_`` are dropped, as JAX's
        ``mode="drop"`` scatter drops them."""
        onehot = owner[None, :] == torch.arange(
            h_count, dtype=owner.dtype, device=dev)[:, None]
        pos = torch.where(onehot, torch.cumsum(onehot, dim=1) - 1, 0).sum(0)
        keep = valid_ & (pos < cap_)
        slot = torch.where(keep, owner.long() * cap_ + pos, h_count * cap_)
        req = torch.zeros(h_count * cap_ + 1, dtype=torch.int32, device=dev)
        req.scatter_(0, slot, local.to(torch.int32))
        return req[:h_count * cap_], pos, onehot.sum(1)

    def exchange(req, owner, pos, cap_, table):
        """Requests out, the owner's read, responses back. Returns the
        received ``[H * cap_, width]`` block and each slot's row in it."""
        incoming = _all_to_all(req, group)
        read = incoming.clamp(0, rows_per_host - 1)
        resp = _all_to_all(gather_rows(table, read), group)
        return resp, owner.clamp(min=0).long() * cap_ + pos

    table = _wire_table(feat)
    owner, local = route(ids, valid)
    if collector is not None:
        collector.add(metrics.EXCH_CALLS, 1)
    if exchange_cap is None or int(exchange_cap) >= batch:
        req, pos, counts = bucket(owner, local, valid, batch)
        if collector is not None:
            collector.peak(metrics.EXCH_BUCKET_MAX, counts.max())
        resp, idx = exchange(req, owner, pos, batch, table)
    else:
        cap = int(exchange_cap)
        u_budget = min(cap * h_count, batch)
        uniq, inv, n_uniq = unique_within_budget(ids, u_budget, valid=valid,
                                                 collector=collector)
        u_valid = uniq != I32_MAX
        owner_u, local_u = route(uniq, u_valid)
        req_u, pos_u, counts = bucket(owner_u, local_u, u_valid, cap)
        bad = ((n_uniq > u_budget) | (counts.max() > cap)) \
            .to(torch.int32).reshape(1)
        # the branch carries collectives: every rank must take the same
        # one, so one scalar all_reduce(MAX) unifies the overflow flag
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
        if collector is not None:
            collector.add(metrics.EXCH_FALLBACK, bad)
            collector.peak(metrics.EXCH_BUCKET_MAX, counts.max())
            collector.peak(metrics.EXCH_CAP, cap)
        if bad.item():
            req, pos, _ = bucket(owner, local, valid, batch)
            resp, idx = exchange(req, owner, pos, batch, table)
        else:
            resp, idx_u = exchange(req_u, owner_u, pos_u.clamp(max=cap - 1),
                                   cap, table)
            idx = idx_u[inv.long()]
    idx = torch.where(valid, idx, -1).to(torch.int32)
    out = _unwire(resp, idx, feat)
    return out if dtype is None else out.to(dtype)


def build_dist_lookup_fn(group, rows_per_host: int, batch_per_host: int,
                         dtype=None, with_replicate: bool = False,
                         exchange_cap: Optional[int] = None,
                         collect_metrics: bool = False,
                         merge_counters: bool = False):
    """The whole DistFeature lookup of one rank:
    ``fn(ids, g2h, loc, feat[, is_rep, rep_rank, bases])`` -> ``[B,
    dim]`` rows (see :func:`dist_lookup_local`; ``ids`` is this rank's
    ``[batch_per_host]`` block, ``feat`` its shard). ``with_replicate``
    takes the three replica operands.

    ``collect_metrics=True`` adds a second output: this rank's
    ``[1, metrics.NUM_COUNTERS]`` int32 counter block (rank ``h``'s row
    of JAX's ``[H, N]``); ``merge_counters=True`` folds it over the
    group on the device first (:func:`metrics.pmerge_counters`) and
    returns the one global ``[NUM_COUNTERS]`` vector on every rank. Rows
    are the same bits either way."""
    if merge_counters and not collect_metrics:
        raise ValueError("merge_counters=True requires "
                         "collect_metrics=True")
    h_count = dist.get_world_size(group)

    def fn(ids, g2h, loc, feat, *rep):
        if bool(rep) != with_replicate:
            raise TypeError("the replica operands (is_rep, rep_rank, "
                            "bases) go with with_replicate=True, and only "
                            "with it")
        col = metrics.Collector(ids.device) if collect_metrics else None
        out = dist_lookup_local(ids.reshape(-1), g2h, loc, feat, group,
                                h_count, rows_per_host, dtype,
                                rep=rep or None, exchange_cap=exchange_cap,
                                collector=col)
        if not collect_metrics:
            return out
        if merge_counters:
            return out, metrics.pmerge_counters(col.counters(), group)
        return out, col.counters()[None]

    return fn


def build_exchange_fn(group, rows_per_host: int, cap: int, dtype=None):
    """The bare exchange of one rank (reference comm.py:127-182):
    ``fn(req, feat)`` with ``req`` ``[H, cap]`` the local rows this rank
    wants of each rank (rank ``h``'s slice of JAX's ``[H, H, cap]``;
    out-of-range ids read row 0 or the last row, clamped) and ``feat``
    its shard -> ``[H, cap, dim]``, the rows it got from each rank. An
    int8 shard lies in packed rows (``quant.pack``), ships them and
    decodes after the exchange, in the store's dequantized dtype unless
    ``dtype`` is given."""
    h_count = dist.get_world_size(group)

    def fn(req, feat):
        table = _wire_table(feat)
        req = req.reshape(h_count * cap).to(torch.int32)
        ids = _all_to_all(req, group).clamp(0, rows_per_host - 1)
        resp = _all_to_all(gather_rows(table, ids), group)
        if quant.is_quantized(feat):
            resp = _unwire(resp, torch.arange(h_count * cap,
                                              dtype=torch.int32,
                                              device=resp.device), feat)
        resp = resp.view(h_count, cap, -1)
        return resp if dtype is None else resp.to(dtype)

    return fn


class TorchComm:
    """The reference ``NcclComm`` surface (rank, world_size, allreduce,
    exchange; quiver_comm.cu:17-86, comm.py:78-182), the counterpart of
    the JAX package's ``TpuComm``.

    Modes:
    - process group (``group`` given, e.g. :func:`init_distributed`'s):
      ``exchange_spmd`` and ``DistFeature.from_partition`` run the
      ``all_to_all`` exchange among its ranks;
    - simulation (``peers``): in-process stand-ins for the other hosts'
      ``Feature`` stores, for single-process tests of the dispatch
      protocol.

    ``send`` and ``recv`` raise, as the JAX package's do: the exchange
    is the ``all_to_all`` pair."""

    def __init__(self, rank: int, world_size: int, comm_id=None,
                 hosts: Optional[int] = None, rank_per_host: int = 1,
                 group=None, peers: Optional[dict] = None):
        if group is not None and (dist.get_rank(group) != rank or
                                  dist.get_world_size(group) != world_size):
            raise ValueError(
                f"rank {rank} of {world_size} does not match the process "
                f"group's rank {dist.get_rank(group)} of "
                f"{dist.get_world_size(group)}")
        self.rank = rank
        self.world_size = world_size
        self.table = HostRankTable(hosts or world_size, rank_per_host)
        self.group = group
        self.peers = peers or {}
        self._exchange_fns = {}

    def allreduce(self, x):
        """The sum of ``x`` over the group's ranks (a new tensor)."""
        if self.world_size == 1:
            return x
        out = torch.as_tensor(x).clone()
        dist.all_reduce(out, group=self.group)
        return out

    def send(self, tensor, dst: int):
        raise NotImplementedError(
            "point-to-point sends are not part of this port's surface; "
            "use exchange_spmd() or DistFeature, whose all_to_all pair is "
            "the exchange")

    recv = send

    def exchange(self, host_ids: Sequence, feature):
        """Fetch rows from every other host's registered peer store:
        ``host_ids[h]`` = local row ids this rank needs from host ``h``.
        Returns per-host row blocks (None for self and for empty
        requests)."""
        results: List[Optional[torch.Tensor]] = [None] * self.table.hosts
        for h in range(self.table.hosts):
            if h == self.rank or len(host_ids[h]) == 0:
                continue
            if h not in self.peers:
                raise ValueError(
                    f"no peer registered for host {h}: with a process "
                    "group, use DistFeature.from_partition (its lookup "
                    "runs the all_to_all exchange) or exchange_spmd()")
            results[h] = self.peers[h][torch.as_tensor(
                np.asarray(host_ids[h]))]
        return results

    def exchange_spmd(self, req_ids: torch.Tensor, feat,
                      cap: Optional[int] = None) -> torch.Tensor:
        """The exchange among the group's ranks: ``req_ids`` ``[H, cap]``
        (this rank's requests of each rank), ``feat`` this rank's shard
        (int8 in packed rows) -> ``[H, cap, dim]`` (see
        :func:`build_exchange_fn`). ``cap``
        defaults to ``req_ids``' last dimension."""
        if self.group is None:
            raise ValueError("exchange_spmd needs a process group")
        if cap is None:
            cap = int(req_ids.shape[-1])
        key = (quant.tier_rows(feat), cap)
        fn = self._exchange_fns.get(key)
        if fn is None:
            fn = build_exchange_fn(self.group, quant.tier_rows(feat), cap)
            self._exchange_fns[key] = fn
        return fn(req_ids, feat)
