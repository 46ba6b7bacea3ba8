"""One process over a clique of devices, on the CPU: the port's sharded
hot tier (``Feature(cache_policy="p2p_clique_replicate" | "shard",
mesh=...)``), its gather (``gather_rows_sharded_plain``, the plain
version of the clique kernel), ``make_mesh``/``replicated``/
``row_sharded``, ``Topo``/``init_p2p``, the multi-group ``ShardTensor``,
``HeteroFeature`` with a sharded type, and ``ServeEngine``/
``build_train_step`` over a clique store, against the JAX package.

JAX shards its hot tier over the tests' 8 virtual CPU devices (``Mesh``
with axis ``"cache"``); the port's mesh names the CPU 8 times, so each
block is its own tensor. Rows are held bit for bit: fp32 and bf16 to
JAX's own lookup, int8 to JAX's stored tiers decoded with a rounded
multiply, then a rounded add (the port's kernels' rounding), and to
JAX's own lookup, which XLA contracts into one fused multiply-add,
within one rounding of the product (``ONE_ROUNDING``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import quiver_tpu as qv
from quiver_tpu.ops import quant as jquant
from quiver_tpu.utils.topo import Topo as JTopo
from quiver_tpu_torch import (CSRTopo, DeviceConfig, Feature, GraphSAGE,
                              HeteroFeature, ServeEngine, ShardTensor,
                              Topo, init_p2p, p2pCliqueTopo)
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import gather
from quiver_tpu_torch.parallel import (build_train_step, init_state,
                                       make_mesh, replicated, row_sharded)

N, DIM = 200, 8
SHARDS = 8
ONE_ROUNDING = 2.0 ** -20
CPU = torch.device("cpu")


def _jmesh():
    return JMesh(np.array(jax.devices()), axis_names=("cache",))


def _mesh(n=SHARDS):
    return make_mesh(("cache",), devices=[CPU] * n)


def _graph(n=N, seed=0):
    g = np.random.default_rng(seed)
    deg = g.integers(0, 20, n)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, n, indptr[-1]).astype(np.int32)
    return indptr, indices


def _table(n=N, dim=DIM, seed=1):
    return np.random.default_rng(seed).standard_normal((n, dim)) \
        .astype(np.float32)


def _bits(a):
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().reshape(-1).numpy().view(np.uint8)
    a = np.asarray(a).reshape(-1)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return np.ascontiguousarray(a).view(np.uint8)


def _same(a, b):
    return tuple(np.shape(a)) == tuple(np.shape(b)) \
        and np.array_equal(_bits(a), _bits(b))


def _decoded(tier):
    """A JAX tier as rows, an int8 tier decoded with two roundings."""
    if jquant.is_quantized(tier):
        return np.asarray(tier.data).astype(np.float32) \
            * np.asarray(tier.scale) + np.asarray(tier.zero)
    return np.asarray(tier)


def _stores(feat, policy=None, hot_rows=N, placement="offload",
            policy_name="p2p_clique_replicate", **kw):
    """JAX's sharded store over its 8-device mesh and the port's over an
    8-entry CPU mesh, the same budget (per device) and topology."""
    indptr, indices = _graph(feat.shape[0])
    row = quant.row_bytes(DIM, quant.resolve_policy(policy))
    budget = -(-hot_rows // SHARDS) * row
    j = qv.Feature(device_cache_size=budget, cache_policy=policy_name,
                   mesh=_jmesh(), dtype_policy=policy,
                   csr_topo=qv.CSRTopo(indptr=indptr, indices=indices),
                   **kw)
    j.from_cpu_tensor(feat)
    t = Feature(device_cache_size=budget, cache_policy=policy_name,
                mesh=_mesh(), dtype_policy=policy, host_placement=placement,
                csr_topo=CSRTopo(indptr=indptr, indices=indices,
                                 device="cpu"), device="cpu", **kw)
    t.from_cpu_tensor(feat)
    return j, t


def _expected(j, ids):
    """JAX's stored tiers read at ``ids`` (node ids, -1 a zero row),
    int8 decoded with two roundings."""
    order = np.asarray(j.feature_order)
    hot = _decoded(j.device_part)[:j.cache_rows]
    tiers = [hot]
    if j.host_part is not None:
        tiers.append(_decoded(j.host_part))
    rows = np.concatenate(tiers).astype(hot.dtype)
    out = rows[order[np.clip(ids, 0, None)]]
    out[ids < 0] = 0
    return out


def _boundary_ids(t):
    """Node ids whose storage rows sit at every block boundary, then
    some anywhere."""
    order = t.feature_order.numpy()
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    block = t.device_part.offsets[1]
    rows = sorted({r for s in range(1, SHARDS + 1)
                   for r in (s * block - 1, s * block)
                   if r < t.size(0)} | {0, t.size(0) - 1})
    g = np.random.default_rng(4)
    return np.concatenate([inv[rows], g.integers(0, t.size(0), 40)]) \
        .astype(np.int64)


# -- meshes and topology ------------------------------------------------------


def test_make_mesh_shapes_and_placements():
    m = make_mesh(("data", "model"), shape=(2, 2), devices=[CPU] * 4)
    assert m.devices.shape == (2, 2) and m.shape == {"data": 2, "model": 2}
    assert m.axis_names == ("data", "model") and m.size == 4
    assert all(d == CPU for d in m.devices.flat)
    one = make_mesh()
    assert one.axis_names == ("data",) and one.devices.shape == (1,)
    assert make_mesh(("cache", "x"), devices=[CPU] * 3).devices.shape \
        == (3, 1)
    assert replicated(m).axis is None and replicated(m).mesh is m
    assert row_sharded(m, "model").axis == "model"
    with pytest.raises(ValueError, match="no axis"):
        row_sharded(m, "cache")


def test_topo_on_the_cpu_is_one_clique():
    t = Topo()
    assert t.cliques == [[-1]] and t.Topo_Dict == {0: [-1]}
    assert t.get_clique_id("cpu") == 0 and t.p2p_clique(0) == [-1]
    assert p2pCliqueTopo is Topo
    assert init_p2p(["cpu", "cpu"]).cliques == [[-1]]
    # the layout of JAX's info(): a header, then one line a clique
    mine, theirs = t.info().splitlines(), JTopo().info().splitlines()
    assert len(mine) == len(theirs) == 2
    assert mine[0].endswith("topology:") and theirs[0].endswith("topology:")
    assert mine[1].startswith("  clique 0 (") and mine[1].endswith("[cpu]")
    assert theirs[1].startswith("  clique 0 (")


# -- the sharded gather's plain version --------------------------------------


def _blocks(kind, sizes=(5, 0, 7, 4)):
    g = np.random.default_rng(9)
    full = torch.from_numpy(g.standard_normal((sum(sizes), 20))
                            .astype(np.float32) * 3)
    if kind in ("bf16", "fp16"):
        full = full.to(torch.bfloat16 if kind == "bf16" else torch.float16)
    if kind == "int8":
        full = quant.quantize(full, "int8")
    if kind == "int8raw":
        full = (full * 10).to(torch.int8)
    cuts = np.cumsum((0,) + sizes)
    blocks = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        blk = quant.tree_map_tier(lambda t: t[lo:hi].contiguous(), full)
        blocks.append(quant.pack(blk) if kind == "int8" else blk)
    return full, blocks, cuts.tolist()


@pytest.mark.parametrize("kind", ["fp32", "bf16", "fp16", "int8raw",
                                  "int8"])
def test_sharded_plain_equals_gather_over_the_concatenation(kind):
    full, blocks, offsets = _blocks(kind)
    tier = gather.prepare_sharded(quant.ShardedTier(blocks, offsets, CPU))
    assert tier.rows == 16 and tier.dim == 20
    ids = torch.tensor([0, 4, 5, 11, 12, 15, 3, 15, 99], dtype=torch.int32)
    want = gather.gather_rows_plain(full, ids)
    got = gather.gather_rows_sharded_plain(tier, ids)
    assert _same(got, want)
    assert _same(gather.gather_rows(tier, ids), want)
    # out=: negative ids keep their rows and read nothing
    neg = torch.tensor([-1, 4, -3, 12, 0], dtype=torch.int32)
    base = torch.full((5, 20), 7, dtype=want.dtype)
    got = gather.gather_rows_sharded(tier, neg, out=base.clone())
    want = gather.gather_rows_plain(full, neg, out=base.clone())
    assert _same(got, want) and (got[0] == 7).all()
    assert _same(tier.unsharded()
                 if kind != "int8" else quant.dequantize(tier.unsharded()),
                 quant.dequantize(full))


def test_sharded_tier_refuses_bad_layouts():
    full, blocks, offsets = _blocks("fp32")
    with pytest.raises(ValueError, match="one offset more"):
        quant.ShardedTier(blocks, offsets[:-1], CPU)
    with pytest.raises(ValueError, match="its offsets"):
        quant.ShardedTier(blocks, [0, 1, 1, 2, 3], CPU)
    mixed = [blocks[0], blocks[2].to(torch.float16)]
    with pytest.raises(ValueError, match="kind, dtype"):
        gather.prepare_sharded(quant.ShardedTier(mixed, [0, 5, 12], CPU))
    q = quant.quantize(full, "int8")
    with pytest.raises(ValueError, match="packed"):
        gather.prepare_sharded(quant.ShardedTier([q], [0, 16], CPU))
    with pytest.raises(ValueError, match="ShardedTier"):
        gather.gather_rows_sharded(full, torch.zeros(1, dtype=torch.int32))


# -- the sharded store against JAX's -----------------------------------------


@pytest.mark.parametrize("policy", [None, "bf16", "int8"], ids=str)
@pytest.mark.parametrize("tiers", ["hbm", "tiered", "tiered_dedup"])
def test_sharded_store_matches_jax(policy, tiers):
    feat = _table()
    kw = {}
    hot = N
    if tiers != "hbm":
        hot = 96
        kw = dict(cold_budget=12, dedup_cold=tiers == "tiered_dedup")
    j, t = _stores(feat, policy, hot_rows=hot, **kw)
    assert t.sharded and t.cache_rows == j.cache_rows
    assert t.mesh.size == SHARDS and len(t.device_part.shards) == SHARDS
    block = t.device_part.offsets[1]
    shards = j.device_part.addressable_shards if policy != "int8" else \
        j.device_part.data.addressable_shards
    assert len(shards) == SHARDS and shards[0].data.shape[0] == block
    # every block holds JAX's shard, codes and sidecars included
    for s, blk in enumerate(t.device_part.shards):
        jl = jquant.tree_map_tier(
            lambda a: np.asarray(a)[s * block:(s + 1) * block],
            j.device_part)
        for a, b in zip(quant.tier_parts(blk),
                        jl if policy == "int8" else (jl,)):
            assert _same(a.contiguous(), b)
    ids = _boundary_ids(t)
    masked = ids.copy()
    masked[::5] = -1
    want = _expected(j, ids)
    for got in (t[ids], t.lookup_tiered(ids),
                t.getitem_masked(masked)[masked >= 0]):
        w = want if got.shape[0] == ids.shape[0] else \
            _expected(j, masked)[masked >= 0]
        assert _same(got, w)
    got = t.getitem_masked(masked)
    assert not got[masked < 0].any()
    jown = np.asarray(j[jnp.asarray(ids)])
    if policy == "int8":
        np.testing.assert_allclose(t[ids].numpy(), jown, rtol=0,
                                   atol=ONE_ROUNDING)
    else:
        assert _same(t[ids], jown)


def test_shard_policy_and_one_device_mesh():
    feat = _table()
    j, t = _stores(feat, policy_name="shard", hot_rows=128)
    assert t.sharded and t.cache_rows == j.cache_rows == 128
    ids = _boundary_ids(t)
    assert _same(t[ids], np.asarray(j[jnp.asarray(ids)]))
    # a clique of one device is replicated, as in JAX
    one = Feature(device_cache_size="1M", cache_policy="p2p_clique_replicate",
                  mesh=_mesh(1), device="cpu").from_cpu_tensor(feat)
    assert not one.sharded and torch.is_tensor(one.device_part)
    # device_list without a mesh: one CPU entry per listed device
    dl = Feature(device_list=[0, 1, 2], device_cache_size=67 * DIM * 4,
                 cache_policy="p2p_clique_replicate",
                 device="cpu").from_cpu_tensor(feat)
    assert dl.sharded and len(dl.device_part.shards) == 3
    assert dl.cache_rows == N         # 3 x 67 rows of budget
    assert _same(dl[np.arange(N)], feat)


def test_128_rows_over_8_shards_give_16_a_shard():
    """Counterpart of ``tests/test_feature.py::test_sharded_policy_on_
    mesh``."""
    feat = _table(128)
    t = Feature(device_cache_size="1M", cache_policy="p2p_clique_replicate",
                mesh=_mesh(), device="cpu").from_cpu_tensor(feat)
    ids = np.array([0, 1, 64, 127, 3])
    assert _same(t[ids], feat[ids])
    assert len(t.device_part.shards) == 8
    assert all(quant.tier_rows(b) == 16 for b in t.device_part.shards)
    assert t.device_part.offsets == list(range(0, 129, 16))


def test_from_mmap_with_a_clique():
    feat = _table(40)
    cfg = qv.DeviceConfig([feat[:10], feat[10:20]], feat[20:])
    j = qv.Feature(cache_policy="p2p_clique_replicate", mesh=_jmesh())
    j.from_mmap(None, cfg)
    t = Feature(cache_policy="p2p_clique_replicate", mesh=_mesh(),
                device="cpu")
    t.from_mmap(None, DeviceConfig([feat[:10], feat[10:20]], feat[20:]))
    assert t.sharded and t.cache_rows == j.cache_rows == 20
    assert t.device_part.offsets[1] == 3          # ceil(20 / 8), padded
    ids = np.array([0, 2, 3, 9, 10, 19, 20, 39])
    assert _same(t[ids], np.asarray(j[jnp.asarray(ids)]))
    assert _same(t[ids], feat[ids])


def test_rotation_refused_on_a_sharded_tier_as_in_jax():
    feat = _table()
    j, t = _stores(feat, hot_rows=96, placement="numpy")
    cold = np.flatnonzero(t.feature_order.numpy() >= t.cache_rows)[:2]
    hot = np.flatnonzero(t.feature_order.numpy() < t.cache_rows)[:2]
    with pytest.raises(ValueError, match="replicated hot tiers only") as a:
        t.rotate_hot_set(cold, hot)
    with pytest.raises(ValueError, match="replicated hot tiers only") as b:
        j.rotate_hot_set(cold, hot)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("policy", [None, "int8"], ids=str)
def test_sharded_store_pickles_and_shards_again(policy):
    import pickle
    feat = _table()
    _, t = _stores(feat, policy, hot_rows=96)
    u = pickle.loads(pickle.dumps(t))
    assert u.sharded and u.device_part.offsets == t.device_part.offsets
    ids = _boundary_ids(t)
    assert _same(u[ids], t[ids])


# -- ShardTensor over several device groups ---------------------------------


@pytest.mark.parametrize("policy", [None, "int8"], ids=str)
def test_shard_tensor_three_device_groups_and_host(policy):
    from quiver_tpu import ShardTensor as JShardTensor
    g = np.random.default_rng(2)
    layout = [(20, 0), (15, -1), (10, 1), (25, 2), (5, -1)]
    blocks = [g.standard_normal((r, DIM)).astype(np.float32) * 2
              for r, _ in layout]
    j = JShardTensor(0, dtype_policy=policy)
    t = ShardTensor(0, dtype_policy=policy, device="cpu")
    for b, (_, dev) in zip(blocks, layout):
        j.append(b, min(dev, 0))          # JAX: one device group works
        t.append(b, dev)
    assert t.shape == j.shape == (75, DIM)
    assert len(t._tier.shards) == 4          # groups 0, -1, 1 and 2
    assert [s.device for s in t._shards] == [0, -1, 1, 2, -1]
    ids = g.integers(-3, 80, 150)
    got, want = t[ids], np.asarray(j[ids])
    host = np.zeros(ids.shape, bool)
    start = 0
    for r, dev in layout:
        if dev < 0:
            host |= (ids >= start) & (ids < start + r)
        start += r
    if policy is None:
        assert _same(got, want)
    else:
        assert _same(got[~host], want[~host])
        np.testing.assert_allclose(got[host], want[host], rtol=0,
                                   atol=ONE_ROUNDING)
    assert not got[(ids < 0) | (ids >= 75)].any()


@pytest.mark.parametrize("policy", [None, "bf16"], ids=str)
def test_shard_tensor_groups_grow_past_64_appends(policy):
    """70 appends that interleave two device groups and the host group:
    three growing groups, rows in logical order, the host group's rows
    in append order."""
    g = np.random.default_rng(4)
    blocks = [g.standard_normal((int(g.integers(1, 6)), DIM))
              .astype(np.float32) for _ in range(70)]
    devs = [(0, -1, 1)[i % 3] for i in range(70)]
    t = ShardTensor(0, dtype_policy=policy, device="cpu")
    for b, dev in zip(blocks, devs):
        t.append(b, dev)
    full = torch.from_numpy(np.concatenate(blocks))
    full = quant.dequantize(quant.quantize(full, policy))
    assert len(t._tier.shards) == 3 and len(t._shards) == 70
    assert t.shape == tuple(full.shape)
    ids = torch.from_numpy(g.integers(-2, full.shape[0] + 2, 300))
    got = t[ids]
    ok = (ids >= 0) & (ids < full.shape[0])
    assert _same(got[ok], full[ids[ok]]) and not got[~ok].any()
    host = np.concatenate([b for b, d in zip(blocks, devs) if d < 0])
    assert _same(quant.dequantize(t.stored(host=True)),
                 quant.dequantize(quant.quantize(torch.from_numpy(host),
                                                 policy)))


# -- hetero, serving and training over a clique store -----------------------


def test_hetero_feature_with_a_sharded_type():
    """Counterpart of ``tests/test_hetero.py::test_mesh_sharded_type``."""
    g = np.random.default_rng(0)
    feats = {"paper": g.standard_normal((120, 16)).astype(np.float32),
             "author": g.standard_normal((60, 16)).astype(np.float32)}
    budget = feats["paper"].shape[0] * 16 * 4 // 8
    jh = qv.HeteroFeature.from_cpu_tensors(
        feats, configs={"paper": dict(
            device_cache_size=budget, cache_policy="p2p_clique_replicate",
            mesh=_jmesh())}, default=dict(device_cache_size="1M"))
    th = HeteroFeature.from_cpu_tensors(
        feats, configs={"paper": dict(
            device_cache_size=budget, cache_policy="p2p_clique_replicate",
            mesh=_mesh())}, default=dict(device_cache_size="1M",
                                         device="cpu"))
    assert th["paper"].sharded and not th["author"].sharded
    ids = g.integers(0, 120, size=32)
    out = th.lookup({"paper": torch.from_numpy(ids),
                     "author": torch.arange(10), "inst": None})
    jout = jh.lookup({"paper": jnp.asarray(ids),
                      "author": jnp.asarray(np.arange(10))})
    assert _same(out["paper"], np.asarray(jout["paper"]))
    assert _same(out["author"], np.asarray(jout["author"]))
    assert _same(out["paper"], feats["paper"][ids])


SIZES, CAP, ROW_CAP, HIDDEN, OUT = [4, 3], 8, 16, 16, 5


def _serve_setup(policy):
    feat = _table()
    indptr, indices = _graph()
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    kw = dict(dtype_policy=policy, host_placement="offload", device="cpu",
              csr_topo=topo)
    row = quant.row_bytes(DIM, quant.resolve_policy(policy))
    clique = Feature(device_cache_size=-(-96 // SHARDS) * row,
                     cache_policy="p2p_clique_replicate", mesh=_mesh(),
                     **kw).from_cpu_tensor(feat)
    repl = Feature(device_cache_size=96 * row, **kw).from_cpu_tensor(feat)
    assert clique.sharded and clique.cache_rows == repl.cache_rows == 96
    return feat, topo, clique, repl


def _params():
    torch.manual_seed(0)
    return GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), dropout=0.0).state_dict()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("policy", [None, "int8"], ids=str)
def test_engine_over_a_clique_store_equals_the_replicate_one(fused, policy):
    feat, topo, clique, repl = _serve_setup(policy)
    engines = [ServeEngine(GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), 0.0),
                           _params(), topo, store, [SIZES], CAP,
                           fused_hot_hop=fused, fused_row_cap=ROW_CAP,
                           device="cpu") for store in (clique, repl)]
    for ids, hs in (([3, 7, 11, 150, 42], [5, -6]), ([0, 199], [9, 9])):
        a, b = (e.run(ids, hop_seeds=hs) for e in engines)
        assert _same(a, b)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_engine_over_a_clique_with_no_cold_tier(fused):
    """The whole table on the clique: the engine takes the sharded tier
    itself (the fused route samples, then the sharded gather) and equals
    the engine over the whole table replicated."""
    feat, topo, _, _ = _serve_setup(None)
    kw = dict(device="cpu", csr_topo=topo)
    whole = Feature(device_cache_size=-(-N // SHARDS) * DIM * 4,
                    cache_policy="p2p_clique_replicate", mesh=_mesh(),
                    **kw).from_cpu_tensor(feat)
    repl = Feature(device_cache_size="1M", **kw).from_cpu_tensor(feat)
    assert whole.sharded and whole._host_offload is None
    assert whole.host_part is None and repl.host_part is None
    engines = [ServeEngine(GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), 0.0),
                           _params(), topo, store, [SIZES], CAP,
                           fused_hot_hop=fused, fused_row_cap=ROW_CAP,
                           device="cpu") for store in (whole, repl)]
    assert quant.is_sharded(engines[0]._feat)
    a, b = (e.run([3, 7, 199], hop_seeds=[5, -6]) for e in engines)
    assert _same(a, b)


def test_clique_engine_matches_jax_engine():
    """The fused clique engine against JAX's fused engine over a
    replicated store of the same rows (the same picks: the counter
    hash), logits within 1e-5."""
    from quiver_tpu.models import GraphSAGE as FlaxSAGE
    from quiver_tpu.ops.pallas.fused import _hop_seed
    from quiver_tpu.ops.sample import compact_layer as jcompact
    from quiver_tpu.parallel.train import layers_to_adjs as jadjs
    from quiver_tpu.serving import ServeEngine as JServeEngine
    from quiver_tpu_torch.models import flax_to_state_dict
    import warnings
    feat, topo, clique, _ = _serve_setup(None)
    indptr, indices = _graph()
    fmodel = FlaxSAGE(hidden_dim=HIDDEN, out_dim=OUT, num_layers=len(SIZES),
                      dropout=0.0)
    layers, cur = [], jnp.full((CAP,), -1, jnp.int32)
    for k in SIZES:
        layers.append(jcompact(cur, jnp.full((cur.shape[0], k), -1,
                                             jnp.int32), seeds_dense=True))
        cur = layers[-1].n_id
    variables = fmodel.init(jax.random.key(0), jnp.zeros((cur.shape[0], DIM)),
                            jadjs(layers, CAP, SIZES))
    jstore = qv.Feature(device_cache_size=96 * DIM * 4,
                        csr_topo=qv.CSRTopo(indptr=indptr, indices=indices))
    jstore.from_cpu_tensor(feat)
    jeng = JServeEngine(fmodel, variables, qv.CSRTopo(indptr=indptr,
                                                      indices=indices),
                        jstore, [SIZES], CAP, fused_hot_hop=True,
                        fused_row_cap=ROW_CAP)
    seeds = np.full((CAP,), -1, np.int32)
    seeds[:5] = [3, 7, 11, 150, 42]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, want = jeng._steps[0](variables, jax.random.key(5), jeng._feat,
                                 jeng._forder, jeng._indptr, jeng._indices,
                                 jnp.asarray(seeds))
    _, sub = jax.random.split(jax.random.key(5))
    hop_seeds = [int(_hop_seed(sub, i)) for i in range(len(SIZES))]
    eng = ServeEngine(GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), 0.0),
                      flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                variables)),
                      topo, clique, [SIZES], CAP, fused_hot_hop=True,
                      fused_row_cap=ROW_CAP, device="cpu")
    got = eng.run(seeds[:5], hop_seeds=hop_seeds)
    np.testing.assert_allclose(got[:5].numpy(), np.asarray(want)[:5],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("policy", [None, "int8"], ids=str)
def test_train_step_over_a_clique_store(fused, policy):
    """One step over the clique store (passed whole) equals one over the
    replicate store bit for bit: loss, gradients and updated
    parameters; a second step from there too."""
    _, topo, clique, repl = _serve_setup(policy)
    seeds = torch.tensor([3, 7, 11, 150, 42, 0, -1, -1], dtype=torch.int32)
    labels = torch.tensor([0, 1, 2, 3, 4, 0, 0, 0])
    out = []
    for store in (clique, repl):
        torch.manual_seed(1)
        model = GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), dropout=0.5)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = build_train_step(model, opt, SIZES, CAP, fused_hot_hop=fused,
                                fused_row_cap=ROW_CAP, collect_metrics=True)
        state = init_state(model, opt)
        losses = []
        for hs, drop in (([5, -6], 11), ([7, 8], 12)):
            state, loss, counters = step(state, store, None, topo.indptr,
                                         topo.indices, seeds, labels, hs,
                                         drop)
            losses.append(loss)
        out.append((losses, [p.detach().clone()
                             for p in model.parameters()], counters))
    (la, pa, ca), (lb, pb, cb) = out
    assert all(_same(x, y) for x, y in zip(la, lb))
    assert all(_same(x, y) for x, y in zip(pa, pb))
    assert torch.equal(ca, cb)
    # the clique's hot tier alone, as a tier: the sharded gather
    whole = Feature(device_cache_size=-(-N // SHARDS) * DIM * 4,
                    cache_policy="p2p_clique_replicate", mesh=_mesh(),
                    device="cpu", csr_topo=topo).from_cpu_tensor(_table())
    model = GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), dropout=0.0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = build_train_step(model, opt, SIZES, CAP, fused_hot_hop=fused,
                            fused_row_cap=ROW_CAP)
    _, loss = step(init_state(model, opt), whole.device_part,
                   whole.feature_order, topo.indptr, topo.indices, seeds,
                   labels, [5, -6], 3)
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="own feature_order"):
        step(init_state(model, opt), whole, whole.feature_order,
             topo.indptr, topo.indices, seeds, labels, [5, -6], 3)
