"""The port's sharded serving (``build_sharded_serve_step`` and
``ShardedServeEngine`` in ``quiver_tpu_torch/serving.py``) against the
JAX package's and against the port's own single-store ``ServeEngine``.

H gloo ranks (one ``RankPool`` of 4 for the module, with a subgroup of
the first 2) each hold one partition of the table and serve the same
seed blocks with the same hop seeds. Held:
- with ``fused_hot_hop=True``, every rank's logits within 1e-5 of JAX's
  ``ShardedServeEngine`` on the hop seeds JAX derives from its key (the
  model's sums run in another order in the two frameworks), and the
  merged counters (frontier, exchange, locality) equal to JAX's;
- on either route, every rank's logits equal, bit for bit, to the
  single-store ``ServeEngine`` over the unpartitioned table (both on the
  CPU, where the sums run in one order), across the dense, compact and
  forced-fallback exchanges, as ``tests/test_serving.py`` pins it for
  JAX;
- the locality counters, the engine's refusals and a
  ``MicroBatchServer``'s ``partition`` block.
Every call into the pool has a time limit (the pool's), and every
collective the group's 60 s timeout."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chip_smoke import RankPool
import quiver_tpu as qv
from quiver_tpu import metrics as jm
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops.pallas.fused import _hop_seed
from quiver_tpu.ops.sample import compact_layer as jcompact
from quiver_tpu.parallel.train import layers_to_adjs as jadjs
from quiver_tpu_torch import (DistFeature, GraphSAGE, MicroBatchServer,
                              PartitionInfo, ServeConfig, ServeEngine,
                              ShardedServeEngine, TorchComm, metrics)
from quiver_tpu_torch.models import flax_to_state_dict

N, DIM, HIDDEN, OUT = 240, 12, 16, 4
SIZES, SHED = [3, 2], [2, 1]
CAP = 8
ROW_CAP = 16


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, subgroups=(2,), timeout=60, call_timeout=120) as p:
        yield p


@pytest.fixture(scope="module")
def world():
    """The graph of ``tests/test_dist_train.py``'s ``setup`` (n 240,
    D 12, 4 classes), a flax GraphSAGE and its weights as a state
    dict."""
    rng = np.random.default_rng(0)
    deg = rng.integers(1, 9, N)
    indptr = np.zeros(N + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    fmodel = FlaxSAGE(hidden_dim=HIDDEN, out_dim=OUT, num_layers=2,
                      dropout=0.0)
    layers, cur = [], jnp.full((CAP,), -1, jnp.int32)
    for k in SIZES:
        layers.append(jcompact(cur, jnp.full((cur.shape[0], k), -1,
                                             jnp.int32), seeds_dense=True))
        cur = layers[-1].n_id
    variables = fmodel.init(jax.random.key(0),
                            jnp.zeros((cur.shape[0], DIM)),
                            jadjs(layers, CAP, SIZES))
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    return dict(indptr=indptr, indices=indices, feat=feat, fmodel=fmodel,
                variables=variables, state=state)


def _g2h(h, seed=3):
    rng = np.random.default_rng(seed)
    g2h = rng.integers(0, h, N).astype(np.int32)
    g2h[:h] = np.arange(h)
    return g2h


def _seed_blocks(count):
    rng = np.random.default_rng(5)
    out = []
    for i in range(count):
        if i % 2 == 0:     # duplicate-heavy: few unique seeds
            ids = np.unique(rng.integers(0, 6, CAP))
        else:              # wide
            ids = rng.choice(N, CAP, replace=False)
        out.append(ids.astype(np.int32))
    return out


# -- the rank side ------------------------------------------------------------


def _model(state):
    model = GraphSAGE(DIM, HIDDEN, OUT, 2, dropout=0.0)
    model.load_state_dict(state)
    return model


def _sharded(ctx, h, w, g2h, cap, collect, fused, seed=9, variants=None):
    group = ctx.groups[h]
    info = PartitionInfo(host=ctx.rank, hosts=h, global2host=g2h)
    dist = DistFeature.from_partition(
        w["feat"], info, TorchComm(ctx.rank, h, group=group),
        exchange_cap=cap, device="cpu")
    return ShardedServeEngine(
        _model(w["state"]), None, (w["indptr"], w["indices"]), dist,
        variants or [SIZES, SHED], CAP, collect_metrics=collect,
        fused_hot_hop=fused, fused_row_cap=ROW_CAP, seed=seed)


def _rank_serve_jax_seeds(ctx, h, w, g2h, blocks, hop_seeds):
    if ctx.groups[h] is None:
        return None
    eng = _sharded(ctx, h, w, g2h, None, True, True, variants=[SIZES])
    out = []
    for seeds, hs in zip(blocks, hop_seeds):
        logits = eng.run(seeds, hop_seeds=hs)
        out.append((logits, eng.last_counters))
    return out


def _rank_serve_vs_single(ctx, h, w, g2h, blocks, cap, fused):
    if ctx.groups[h] is None:
        return None
    eng = _sharded(ctx, h, w, g2h, cap, True, fused)
    single = ServeEngine(_model(w["state"]), None,
                         (w["indptr"], w["indices"]), w["feat"],
                         [SIZES, SHED], CAP, fused_hot_hop=fused,
                         fused_row_cap=ROW_CAP, seed=9, device="cpu")
    out = []
    for i, seeds in enumerate(blocks):
        got = eng.run(seeds, variant=i % 2)
        want = single.run(seeds, variant=i % 2)
        out.append((got, want, eng.last_counters))
    return out


def _rank_refusals(ctx, h, w, g2h):
    if ctx.groups[h] is None:
        return None
    group = ctx.groups[h]
    info = PartitionInfo(host=ctx.rank, hosts=h, global2host=g2h,
                         replicate=np.array([1, 2], np.int32))
    rep = DistFeature.from_partition(
        w["feat"], info, TorchComm(ctx.rank, h, group=group), device="cpu")
    msgs = []
    for dist, variants in ((rep, [SIZES]),
                           (DistFeature(None, info, None), [SIZES])):
        try:
            ShardedServeEngine(_model(w["state"]), None,
                               (w["indptr"], w["indices"]), dist, variants,
                               CAP)
        except ValueError as e:
            msgs.append(str(e))
    eng = _sharded(ctx, h, w, g2h, None, False, False)
    try:
        _sharded(ctx, h, w, g2h, None, False, False,
                 variants=[SIZES, [2]])
    except ValueError as e:
        msgs.append(str(e))
    return msgs, eng.home, eng.partitions


def _rank_server(ctx, h, w, g2h):
    """One request through a ``MicroBatchServer`` on every rank (the same
    request, so the ranks' engines run in step)."""
    if ctx.groups[h] is None:
        return None
    eng = _sharded(ctx, h, w, g2h, 32, False, True)
    with MicroBatchServer(eng, ServeConfig(max_wait_ms=1.0)) as srv:
        row = srv.submit(3).result(timeout=60)
        snap = srv.snapshot()["serving"]
    return row, snap["partition"]


# -- the tests ----------------------------------------------------------------


def _jax_hop_seeds(seed, runs, hops):
    """The hop seeds JAX's engine derives on its ``runs`` dispatches:
    each run splits its key and seeds hop ``i`` from the subkey."""
    key, out = jax.random.key(seed), []
    for _ in range(runs):
        key, sub = jax.random.split(key)
        out.append([int(_hop_seed(sub, i)) for i in range(hops)])
    return out


@pytest.mark.parametrize("h", [2, 4])
def test_fused_sharded_engine_matches_jax(pool, world, h):
    w = world
    g2h = _g2h(h)
    mesh = Mesh(np.array(jax.devices()[:h]), ("host",))
    jdist = qv.DistFeature.from_partition(
        w["feat"], qv.PartitionInfo(host=0, hosts=h, global2host=g2h),
        qv.TpuComm(rank=0, world_size=h, mesh=mesh, axis="host"),
        collect_metrics=True)
    jeng = qv.ShardedServeEngine(
        w["fmodel"], w["variables"], (jnp.asarray(w["indptr"]),
                                      jnp.asarray(w["indices"])),
        jdist, sizes_variants=[SIZES], batch_cap=CAP, collect_metrics=True,
        fused_hot_hop=True, fused_row_cap=ROW_CAP, seed=9)
    blocks = _seed_blocks(3)
    want = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # JAX pads D=12 to 128 lanes
        for seeds in blocks:
            logits = np.asarray(jeng.run(seeds))
            want.append((logits, np.asarray(jeng.last_counters)))
    hop_seeds = _jax_hop_seeds(9, len(blocks), len(SIZES))
    res = pool.run(_rank_serve_jax_seeds, h, w, g2h, blocks, hop_seeds)[:h]
    for rank_out in res:
        for (got, counters), (logits, jcounters), seeds in zip(
                rank_out, want, blocks):
            n = seeds.shape[0]
            np.testing.assert_allclose(got[:n], logits[:n], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_array_equal(counters, jcounters)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cap,fallback", [(None, None), (64, False),
                                          (2, True)])
@pytest.mark.parametrize("h", [2, 4])
def test_sharded_equals_single_store(pool, world, h, cap, fallback, fused):
    blocks = _seed_blocks(4)
    res = pool.run(_rank_serve_vs_single, h, world, _g2h(h), blocks, cap,
                   fused)[:h]
    compact = 0
    for rank_out in res:
        for (got, want, c), theirs in zip(rank_out, res[0]):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(c, theirs[2])
            assert c[metrics.EXCH_CALLS] == h
            hit, miss = c[metrics.LOCALITY_HIT_ROWS], \
                c[metrics.LOCALITY_MISS_ROWS]
            assert hit + miss == c[metrics.FRONTIER_VALID] > 0
            # the shed rung's 48-slot frontier takes the dense exchange
            # under a cap of 64: no cap recorded there (blocks 1 and 3)
            compact += c[metrics.EXCH_CAP] == cap
            if fallback is True:
                assert c[metrics.EXCH_FALLBACK] == h
            elif fallback is False:
                assert c[metrics.EXCH_FALLBACK] == 0
    assert compact == {None: 0, 64: 2, 2: 4}[cap] * h


def test_engine_refusals(pool, world):
    res = pool.run(_rank_refusals, 2, world, _g2h(2))
    for rank, r in enumerate(res[:2]):
        msgs, home, parts = r
        assert "replicated-tail" in msgs[0]
        assert "from_partition" in msgs[1]
        assert "hop count" in msgs[2]
        assert (home, parts) == (rank, 2)


def test_server_snapshot_names_partition(pool, world):
    res = pool.run(_rank_server, 2, world, _g2h(2))
    for rank, (row, part) in enumerate(res[:2]):
        assert row.shape == (OUT,)
        np.testing.assert_array_equal(row, res[0][0])
        assert part == {"home": rank, "partitions": 2}
