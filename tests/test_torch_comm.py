"""The port's exchange (``quiver_tpu_torch/comm.py``) against the JAX
package's (``quiver_tpu/comm.py``).

The JAX side runs its single-controller lookup on a mesh of H virtual
CPU devices over the concatenated ``[H*B]`` ids; the port runs H gloo
ranks (one ``RankPool`` of 4 ranks for the module, with a subgroup of
the first 2), each looking up its own ``[B]`` block, and rank ``h``'s
rows must equal slice ``h`` of JAX's output bit for bit: fp32 and bf16
exactly; int8 exactly against JAX's codes decoded with two roundings (a
rounded multiply, then a rounded add, as the kernels decode), and within
1e-6 of JAX's own rows, which XLA decodes with one fused multiply-add.
The counters of a metered lookup equal JAX's, per rank and merged.
Every call into the pool has a time limit (the pool's), and every
collective the group's 60 s timeout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chip_smoke import RankPool
import quiver_tpu as qv
from quiver_tpu import comm as jcomm
from quiver_tpu import metrics as jm
from quiver_tpu._compat import shard_map
from quiver_tpu.ops import dedup as jdedup
from quiver_tpu.ops import quant as jquant
from quiver_tpu_torch import (DistFeature, Feature, PartitionInfo,
                              TorchComm, comm, metrics, quantize)
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.dedup import compact_exchange_slots

N, DIM = 240, 12
B = 32                                 # ids per rank


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, subgroups=(2,), timeout=60, call_timeout=120) as p:
        yield p


def _mesh(h):
    return Mesh(np.array(jax.devices()[:h]), ("host",))


def _g2h(rng, h):
    g2h = rng.integers(0, h, N).astype(np.int32)
    g2h[:h] = np.arange(h)
    return g2h


def _bits(a):
    """A row block's bits: numpy of any float dtype (bf16 tensors
    too) as unsigned integers."""
    if torch.is_tensor(a):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _decode2(feat, ids):
    """JAX's int8 codes of ``feat`` decoded with two roundings, at
    ``ids`` (+0.0 rows at -1)."""
    q = jquant.quantize(jnp.asarray(feat), "int8")
    codes, scale, zero = (np.asarray(x) for x in (q.data, q.scale, q.zero))
    rows = codes.astype(np.float32) * scale + zero
    return np.where((ids >= 0)[:, None], rows[np.maximum(ids, 0)],
                    np.float32(0))


# -- the rank side ------------------------------------------------------------


def _rank_lookup(ctx, h, feat, g2h, rep, ids, kw):
    """This rank's block of a ``DistFeature`` lookup and its counters."""
    group = ctx.groups[h]
    if group is None:
        return None
    info = PartitionInfo(host=ctx.rank, hosts=h, global2host=g2h,
                         replicate=rep)
    dist = DistFeature.from_partition(
        feat, info, TorchComm(ctx.rank, h, group=group), device="cpu", **kw)
    out = dist[ids[ctx.rank * B:(ctx.rank + 1) * B]]
    return out, dist.last_counters


def _rank_exchange(ctx, h, shards, req, policy):
    group = ctx.groups[h]
    if group is None:
        return None
    shard = torch.from_numpy(shards[ctx.rank])
    if policy:
        shard = quant.pack(quantize(shard, policy))
    c = TorchComm(ctx.rank, h, group=group)
    return c.exchange_spmd(torch.from_numpy(req[ctx.rank]), shard)


def _rank_pmerge(ctx, h, vecs):
    group = ctx.groups[h]
    if group is None:
        return None
    return metrics.pmerge_counters(torch.from_numpy(vecs[ctx.rank]), group)


def _rank_lookup_fn(ctx, h, feat, g2h, ids, cap):
    """``build_dist_lookup_fn`` over a hand-built shard, with the three
    replica operands of a store without replicas."""
    group = ctx.groups[h]
    if group is None:
        return None
    info = PartitionInfo(host=ctx.rank, hosts=h, global2host=g2h)
    d = DistFeature.from_partition(
        feat, info, TorchComm(ctx.rank, h, group=group), device="cpu")
    fn = comm.build_dist_lookup_fn(group, d._rows_per_host, B,
                                   with_replicate=True, exchange_cap=cap,
                                   collect_metrics=True)
    rep = (torch.zeros(N, dtype=torch.bool),
           torch.zeros(N, dtype=torch.int32),
           torch.tensor(info.local_sizes, dtype=torch.int32))
    out, counters = fn(torch.from_numpy(ids[ctx.rank * B:(ctx.rank + 1) * B]),
                       d._g2h, d._g2l, d.shard, *rep)
    with pytest.raises(TypeError, match="with_replicate"):
        fn(torch.from_numpy(ids[:B]), d._g2h, d._g2l, d.shard)
    return out, counters


# -- the lookup ---------------------------------------------------------------

# mode -> (DistFeature kwargs, id kind, replicate, collect, merge)
MODES = {
    "dense": ({}, "wide", None, True, False),
    "dense_merged": ({}, "wide", None, True, True),
    "compact": ({"exchange_cap": 12}, "dups", None, True, False),
    "compact_merged": ({"exchange_cap": 12}, "dups", None, True, True),
    "overflow": ({"exchange_cap": 2}, "wide", None, True, True),
    "cap_true": ({"exchange_cap": True}, "dups", None, True, False),
    "replicate": ({}, "rep", np.array([3, 77, 140], np.int32), False, False),
    "replicate_compact": ({"exchange_cap": 8}, "rep",
                          np.array([3, 77, 140], np.int32), False, False),
    "bf16": ({"dtype_policy": "bf16"}, "wide", None, False, False),
    "fp16_compact": ({"dtype_policy": "fp16", "exchange_cap": 12}, "dups",
                     None, False, False),
    "int8": ({"dtype_policy": "int8"}, "wide", None, False, False),
    "int8_compact": ({"dtype_policy": "int8", "exchange_cap": 12}, "dups",
                     None, True, True),
    "dedup": ({"dedup_cold": True}, "dups", None, False, False),
    "dedup_budget": ({"dedup_cold": 16}, "dups", None, False, False),
    "dedup_overflow": ({"dedup_cold": True}, "wide", None, False, False),
}


def _ids(rng, kind, h, rep):
    n = h * B
    if kind == "wide":
        ids = rng.integers(0, N, n)
    elif kind == "dups":
        ids = rng.choice(N, 12, replace=False)[rng.integers(0, 12, n)]
    else:
        ids = np.where(rng.random(n) < 0.4, rep[rng.integers(0, rep.size, n)],
                       rng.integers(0, N, n))
    ids = ids.astype(np.int32)
    ids[::7] = -1
    if kind == "wide":
        ids[:B // 2] = -1          # half of rank 0's block is padding
    return ids


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("h", [2, 4])
def test_lookup_matches_jax(pool, h, mode):
    kw, kind, rep, collect, merge = MODES[mode]
    rng = np.random.default_rng(h * 100 + len(mode))
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    g2h = _g2h(rng, h)
    ids = _ids(rng, kind, h, rep)
    kw = dict(kw, collect_metrics=collect, merge_counters=merge)

    jinfo = qv.PartitionInfo(host=0, hosts=h, global2host=g2h,
                             replicate=rep)
    jc = qv.TpuComm(rank=0, world_size=h, mesh=_mesh(h), axis="host")
    jd = qv.DistFeature.from_partition(feat, jinfo, jc, **kw)
    want = np.asarray(jd[jnp.asarray(ids)])

    res = pool.run(_rank_lookup, h, feat, g2h, rep, ids, kw)[:h]
    got = [r[0] for r in res]
    if kw.get("dtype_policy") == "int8":
        got = np.concatenate(got)
        assert got.dtype == np.float32
        # bits of the two-rounding decode; JAX's FMA within one rounding
        np.testing.assert_array_equal(_bits(got), _bits(_decode2(feat, ids)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        got = np.concatenate([_bits(g) for g in got])
        np.testing.assert_array_equal(got, _bits(want))
    if collect:
        counters = np.concatenate([np.asarray(r[1]).reshape(-1, jm.NUM_COUNTERS)
                                   for r in res])
        if merge:          # every rank holds the one merged vector
            assert all(np.array_equal(np.asarray(r[1]), counters[0])
                       for r in res)
            counters = counters[:1]
        np.testing.assert_array_equal(
            counters, np.asarray(jd.last_counters).reshape(
                -1, jm.NUM_COUNTERS))
        if mode == "overflow":
            assert counters[0, jm.EXCH_FALLBACK] == h
        if mode.startswith("compact"):
            assert counters[:, jm.EXCH_FALLBACK].sum() == 0


def test_lookup_fn_takes_replica_operands(pool):
    """``build_dist_lookup_fn(with_replicate=True)`` with empty replica
    operands gives the plain rows, and refuses a call without them."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    g2h = _g2h(rng, 4)
    ids = _ids(rng, "dups", 4, None)
    res = pool.run(_rank_lookup_fn, 4, feat, g2h, ids, 8)
    got = np.concatenate([r[0] for r in res])
    want = np.where((ids >= 0)[:, None], feat[np.maximum(ids, 0)], 0)
    np.testing.assert_array_equal(_bits(got), _bits(want.astype(np.float32)))
    assert all(np.asarray(r[1])[0, metrics.EXCH_CALLS] == 1 for r in res)


@pytest.mark.parametrize("policy", [None, "int8"])
@pytest.mark.parametrize("h", [2, 4])
def test_exchange_spmd_matches_jax(pool, h, policy):
    """``TorchComm.exchange_spmd``: rank ``s`` gets ``resp[s]`` of JAX's
    ``[H, H, cap, dim]``, requests out of range clamped as JAX clamps
    them."""
    rng = np.random.default_rng(h)
    rows, cap = 16, 5
    feat = rng.standard_normal((h * rows, DIM)).astype(np.float32)
    req = rng.integers(-2, rows + 2, size=(h, h, cap)).astype(np.int32)
    mesh = _mesh(h)
    jfeat = jnp.asarray(feat) if policy is None else \
        jquant.quantize(jnp.asarray(feat), policy)
    jfeat = jquant.tree_map_tier(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("host"))), jfeat)
    want = np.asarray(qv.TpuComm(rank=0, world_size=h, mesh=mesh)
                      .exchange_spmd(jnp.asarray(req), jfeat, cap))
    shards = [feat[r * rows:(r + 1) * rows] for r in range(h)]
    got = np.stack(pool.run(_rank_exchange, h, shards, req, policy)[:h])
    assert got.shape == (h, h, cap, DIM)
    if policy is None:
        np.testing.assert_array_equal(got, want)
    else:
        ids = (np.arange(h)[None, :, None] * rows
               + np.clip(req, 0, rows - 1)).reshape(-1)
        np.testing.assert_array_equal(
            _bits(got.reshape(-1, DIM)), _bits(_decode2(feat, ids)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _rank_refuses_unpacked(ctx, h):
    """The error each entry point raises on an int8 shard with
    contiguous leaves; raised before any collective, so every rank
    returns."""
    group = ctx.groups[h]
    if group is None:
        return None
    shard = quantize(torch.ones(8, DIM), "int8")
    g2h = torch.zeros(8, dtype=torch.int32)
    calls = (lambda: TorchComm(ctx.rank, h, group=group).exchange_spmd(
                 torch.zeros((h, 2), dtype=torch.int32), shard),
             lambda: comm.build_dist_lookup_fn(group, 8, 4)(
                 torch.zeros(4, dtype=torch.int32), g2h, g2h, shard))
    errors = []
    for call in calls:
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


def test_exchange_takes_packed_int8_shards(pool):
    """An int8 shard crosses the wire in packed rows (``quant.pack``):
    the owner ships those rows as they lie, codes then sidecars; a shard
    with contiguous leaves is refused, never repacked on each lookup."""
    rng = np.random.default_rng(1)
    q = quantize(torch.from_numpy(
        rng.standard_normal((16, DIM)).astype(np.float32)), "int8")
    wire = comm._wire_table(quant.pack(q))
    assert tuple(wire.shape) == (16, quant.packed_stride(DIM))
    back = quant.packed_views(wire.contiguous().view(torch.uint8), DIM)
    for a, b in zip(back, q):
        assert torch.equal(a.reshape(-1), b.reshape(-1))
    with pytest.raises(ValueError, match="packed rows"):
        comm._wire_table(q)
    errors = pool.run(_rank_refuses_unpacked, 2)
    assert errors[2:] == [None, None]
    assert all("quant.pack" in e for r in errors[:2] for e in r)


@pytest.mark.parametrize("h", [2, 4])
def test_pmerge_counters_matches_jax(pool, h):
    rng = np.random.default_rng(h + 40)
    vecs = rng.integers(0, 1000, (h, jm.NUM_COUNTERS)).astype(np.int32)
    mesh = _mesh(h)
    f = jax.jit(shard_map(lambda v: jm.pmerge_counters(v.reshape(-1),
                                                       "host"),
                          mesh=mesh, in_specs=P("host"), out_specs=P(),
                          check_vma=False))
    want = np.asarray(f(jnp.asarray(vecs.reshape(-1))))
    got = pool.run(_rank_pmerge, h, vecs)[:h]
    for g in got:
        np.testing.assert_array_equal(g, want)


# -- host-side pieces -----------------------------------------------------------


@pytest.mark.parametrize("ws", [2, 3, 5, 8])
def test_schedule_and_rank_table(ws):
    rng = np.random.default_rng(ws)
    sizes = rng.integers(0, 5, (ws, ws))
    assert comm.schedule(sizes) == jcomm.schedule(sizes)
    ours, theirs = comm.HostRankTable(ws, 2), jcomm.HostRankTable(ws, 2)
    assert ours.world_size == theirs.world_size
    for r in range(ws * 2):
        assert ours.host_lane(r) == theirs.host_lane(r)
    for host in range(ws):
        assert ours.ranks_of_host(host) == theirs.ranks_of_host(host)
        assert ours.rank(host, 1) == theirs.rank(host, 1)
    assert comm.get_comm_id() == jcomm.get_comm_id()


@pytest.mark.parametrize("batch,hosts", [(8, 2), (128, 8), (4096, 4),
                                         (1_081_344, 4), (3, 8)])
def test_cap_sizing_equals_jax(batch, hosts):
    assert comm.default_exchange_cap(batch, hosts) == \
        jcomm.default_exchange_cap(batch, hosts)
    for load in (0.0, 0.5, 7.0, batch / hosts):
        assert comm.cap_for_expected_load(load) == \
            jcomm.cap_for_expected_load(load)


@pytest.mark.parametrize("cap", [None, 1, 3, 8, 64])
@pytest.mark.parametrize("owner", [False, True])
def test_compact_exchange_slots_equals_jax(cap, owner):
    rng = np.random.default_rng(cap or 0)
    ids = rng.integers(-1, 60, 48).astype(np.int32)
    g2h = rng.integers(0, 4, 60).astype(np.int32) if owner else None
    assert compact_exchange_slots(
        torch.from_numpy(ids), cap, 4,
        None if g2h is None else torch.from_numpy(g2h)) == \
        jdedup.compact_exchange_slots(ids, cap, 4, g2h)


def test_simulated_peers():
    """The local/peers mode: host 0's ``Feature`` and host 1's in the
    peer registry give the full table's rows (as JAX's
    ``TestDistFeature``), and the refusals of a comm without a group."""
    rng = np.random.default_rng(0)
    n = 40
    full = rng.standard_normal((n, 8)).astype(np.float32)
    g2h = (np.arange(n) % 2).astype(np.int32)

    def local(part):
        f = Feature(device_cache_size=part.nbytes, device="cpu")
        f.from_cpu_tensor(torch.from_numpy(part))
        return f

    f0, f1 = local(full[g2h == 0]), local(full[g2h == 1])
    info = PartitionInfo(host=0, hosts=2, global2host=g2h)
    c = TorchComm(rank=0, world_size=2, peers={1: f1})
    ids = rng.integers(0, n, 17)
    out = DistFeature(f0, info, c)[ids]
    np.testing.assert_array_equal(out.numpy(), full[ids])
    with pytest.raises(ValueError, match="no peer registered"):
        TorchComm(rank=0, world_size=2).exchange([[], [1]], f0)
    with pytest.raises(NotImplementedError, match="all_to_all"):
        c.send(torch.zeros(1), 1)
    with pytest.raises(NotImplementedError):
        c.recv(torch.zeros(1), 1)
    with pytest.raises(ValueError, match="process group"):
        DistFeature.from_partition(full, info, c, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        c.exchange_spmd(torch.zeros((2, 1), dtype=torch.int32), f0)
    one = TorchComm(rank=0, world_size=1)
    assert torch.equal(one.allreduce(torch.ones(2)), torch.ones(2))
