"""The port's device counters (``quiver_tpu_torch/metrics.py``) against
the JAX package's (``quiver_tpu/metrics.py``), on the CPU.

The host primitives (``merge_counters``, ``reduce_counters``,
``derive``, ``counters_dict``, ``merge_named_counters``,
``Collector.absorb``, ``StepStats``, ``SloBudget``, ``report``) give
JAX's values exactly on the same vectors, and JSONL written by either
package reads the same in the other.

The metered paths count exactly what JAX's count where the two draw the
same picks: the tiered lookup (offload, numpy and all-hot stores,
masked or not, dedup off, narrow and overflowing), the fused train step
and the fused tiered ``ServeEngine`` on replayed hop seeds (JAX run as
its own tests run it: interpret mode, ``"hash"`` PRNG). Where the port
draws from a ``torch.Generator`` (the split routes, ``GraphSageSampler``)
``FRONTIER_CAP`` is JAX's and ``FRONTIER_VALID`` the port's own count
of valid ``n_id``. Rows, logits and losses are bit-identical with
metering on and off."""

import datetime
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import quiver_tpu as qv
from quiver_tpu import metrics as jm
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops import quant as jquant
from quiver_tpu.ops import sample as jsample
from quiver_tpu.ops.pallas import fused as jfused
from quiver_tpu.parallel import train as jtrain
from quiver_tpu.pyg import GraphSageSampler as JSampler
from quiver_tpu.serving import ServeEngine as JServeEngine
from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, GraphSageSampler,
                              ServeEngine, metrics, quantize)
from quiver_tpu_torch.models import flax_to_state_dict
from quiver_tpu_torch.parallel import (build_split_train_step,
                                       build_train_step, init_state)
from quiver_tpu_torch.serving import sample_multihop_serving

N, DIM, HIDDEN, OUT = 200, 8, 16, 5
BS, ROW_CAP = 8, 16


def _graph(n=N, seed=0):
    g = np.random.default_rng(seed)
    deg = g.integers(0, 20, n)
    deg[:3] = 0
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, n, indptr[-1]).astype(np.int32)
    return indptr, indices


def _table(n=N, seed=1):
    return np.random.default_rng(seed).standard_normal((n, DIM)) \
        .astype(np.float32)


def _vec(c):
    return np.asarray(c.numpy() if torch.is_tensor(c) else c)


def _jax(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # JAX pads narrow rows to lanes
        return jax.device_get(fn(*args, **kw))


# -- the host primitives ------------------------------------------------------


def _random_vectors(seed, k=4):
    g = np.random.default_rng(seed)
    return g.integers(0, 1000, (k, metrics.NUM_COUNTERS)).astype(np.int32)


def test_slot_layout_is_the_jax_one():
    assert metrics.NUM_COUNTERS == jm.NUM_COUNTERS
    assert metrics.MAX_SLOTS == jm.MAX_SLOTS
    assert metrics.SLOT_NAMES == jm.SLOT_NAMES
    for k, v in vars(jm).items():         # every slot constant, by name
        if k.isupper() and type(v) is int:
            assert getattr(metrics, k) == v, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_reduce_derive_equal_jax(seed):
    vecs = _random_vectors(seed)
    vecs[0, :] = 0                    # a row that leaves ratios undefined
    a, b = torch.from_numpy(vecs[1]), torch.from_numpy(vecs[2])
    assert np.array_equal(_vec(metrics.merge_counters(a, b)),
                          np.asarray(jm.merge_counters(vecs[1], vecs[2])))
    assert np.array_equal(metrics.merge_counters(vecs[1], vecs[2]),
                          np.asarray(jm.merge_counters(vecs[1], vecs[2])))
    for stack in (vecs, vecs[:2], vecs.reshape(2, 2, -1)):
        assert np.array_equal(metrics.reduce_counters(torch.from_numpy(stack)),
                              jm.reduce_counters(stack))
    for v in (vecs[0], vecs[3], vecs):
        assert metrics.derive(torch.from_numpy(v)) == jm.derive(v)
        assert metrics.counters_dict(torch.from_numpy(v)) \
            == jm.counters_dict(v)
        assert metrics.report(torch.from_numpy(v)) == jm.report(v)
    da, db = jm.counters_dict(vecs[1]), jm.counters_dict(vecs[2])
    db["a_new_slot"] = 3
    assert metrics.merge_named_counters(da, db) \
        == jm.merge_named_counters(da, db)


@pytest.mark.parametrize("seed", [0, 1])
def test_collector_equals_jax(seed, tmp_path):
    """Adds and peaks of Python ints, bools and 0-d tensors, and absorbed
    vectors, give JAX's ``Collector.counters()``."""
    g = np.random.default_rng(seed)
    ours, theirs = metrics.Collector(), jm.Collector()
    for _ in range(30):
        slot = int(g.integers(0, metrics.NUM_COUNTERS))
        val = int(g.integers(0, 500))
        peak = slot in metrics.MAX_SLOTS
        kind = g.integers(0, 3)
        t = val if kind == 0 else (torch.tensor(val) if kind == 1
                                   else torch.tensor(val > 250))
        j = val if kind == 0 else (jnp.asarray(val) if kind == 1
                                   else jnp.asarray(val > 250))
        (ours.peak if peak else ours.add)(slot, t)
        (theirs.peak if peak else theirs.add)(slot, j)
    for v in _random_vectors(seed + 7, 2):
        ours.absorb(torch.from_numpy(v))
        theirs.absorb(jnp.asarray(v))
    got = ours.counters()
    assert got.dtype == torch.int32 and got.shape == (metrics.NUM_COUNTERS,)
    assert np.array_equal(_vec(got), np.asarray(theirs.counters()))
    assert np.array_equal(_vec(metrics.Collector().counters()),
                          np.asarray(jm.Collector().counters()))
    # the cross-rank merge over a one-rank gloo group is the vector
    # itself (the multi-rank cases are in test_torch_comm.py)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        assert np.array_equal(_vec(metrics.pmerge_counters(got)), _vec(got))
    finally:
        dist.destroy_process_group()


def test_step_stats_fold_and_percentiles_equal_jax():
    g = np.random.default_rng(4)
    ours, theirs = metrics.StepStats(fold_every=3), jm.StepStats(fold_every=3)
    for i, v in enumerate(_random_vectors(5, 11)):
        dt = float(g.lognormal(-5, 1))
        ours.record_step(dt, torch.from_numpy(v) if i % 2 else None)
        theirs.record_step(dt, v if i % 2 else None)
        if i % 4 == 0:
            ours.add_counters(torch.from_numpy(v))
            theirs.add_counters(v)
        ours.record_request(dt * 2)
        theirs.record_request(dt * 2)
    assert np.array_equal(ours.counters(), theirs.counters())
    assert ours.snapshot() == theirs.snapshot()
    assert ours.report() == theirs.report()
    assert ours.request_p99_ms() == theirs.request_p99_ms()
    # the port's steps run eagerly: nothing to watch, no recompiles field
    ours.watch_compiles(lambda: 0)
    assert "recompiles" not in ours.snapshot()
    # watch_pipeline is ported: its queue record is held to JAX's in
    # tests/test_torch_pipeline.py
    from quiver_tpu_torch.pipeline import Pipeline
    with Pipeline(depth=2) as p:
        assert ours.watch_pipeline(p) is ours
        p.submit(lambda: 0).result(timeout=10)
        assert ours.snapshot()["queue"]["completed"] == 1


def test_step_stats_folds_lazily():
    """The vector just filed is never read: with ``fold_every=1`` the
    second record folds only the first."""
    s = metrics.StepStats(fold_every=1)
    s.record_step(0.001, torch.ones(metrics.NUM_COUNTERS, dtype=torch.int32))
    s.record_step(0.001, torch.ones(metrics.NUM_COUNTERS, dtype=torch.int32))
    assert len(s._pending) == 1 and s._counters[metrics.HOT_ROWS] == 1
    assert s.counters()[metrics.HOT_ROWS] == 2


def test_slo_budget_equals_jax():
    now = [1000.0]
    ours = metrics.SloBudget(10.0, window_s=60, short_window_s=10,
                             min_requests=5, clock=lambda: now[0])
    theirs = jm.SloBudget(10.0, window_s=60, short_window_s=10,
                          min_requests=5, clock=lambda: now[0])
    g = np.random.default_rng(2)
    for _ in range(80):
        now[0] += float(g.uniform(0, 2))
        lat, ok = float(g.uniform(0, 0.02)), bool(g.uniform() > 0.05)
        ours.record(lat, ok)
        theirs.record(lat, ok)
        assert ours.should_shed() == theirs.should_shed()
    assert ours.snapshot() == theirs.snapshot()
    assert ours.budget_remaining() == theirs.budget_remaining()
    with pytest.raises(ValueError, match="availability"):
        metrics.SloBudget(1.0, availability=1.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jsonl_reads_across_packages(tmp_path, writer):
    path = tmp_path / "m.jsonl"
    stats = (metrics if writer == "port" else jm).StepStats()
    vec = _random_vectors(9, 1)[0]
    stats.record_step(0.004, torch.from_numpy(vec) if writer == "port"
                      else vec)
    sink_cls = metrics.MetricsSink if writer == "port" else jm.MetricsSink
    with sink_cls(str(path), max_bytes=600, replica="r1") as sink:
        for i in range(4):
            sink.emit_stats(stats)
            sink.emit({"i": i, "arr": torch.arange(3) if writer == "port"
                       else np.arange(3)}, kind="bench")
    assert (tmp_path / "m.jsonl.1").exists()      # rolled over
    ours, theirs = metrics.read_jsonl(path), jm.read_jsonl(path)
    assert ours == theirs and len(ours) > 4
    kinds = [r["kind"] for r in ours]
    assert kinds.count("meta") >= 2 and "step_stats" in kinds
    rec = next(r for r in ours if r["kind"] == "step_stats")
    assert rec["counters"] == jm.counters_dict(vec)
    assert [r["arr"] for r in ours if r["kind"] == "bench"][-1] == [0, 1, 2]
    with open(path, "a") as f:
        f.write('{"torn": ')
    assert metrics.read_jsonl(path) == jm.read_jsonl(path)


def test_report_sections():
    metrics.register_report_section("x", lambda: "section x")
    metrics.register_report_section("bad", lambda: 1 / 0)
    try:
        text = metrics.report()
        assert "section x" in text and "bad: <report failed" in text
        assert text.startswith(metrics.stats().report().splitlines()[0])
    finally:
        metrics.unregister_report_section("x")
        metrics.unregister_report_section("bad")
    assert "section x" not in metrics.report()


# -- the tiered lookup --------------------------------------------------------

# dedup knobs: (dedup_cold, cold_budget); 64 ids over 12 distinct nodes
DEDUP = {"off": (False, 16), "narrow": (True, 16), "overflow": (True, 4),
         "int": (6, None)}


def _lookup_stores(kind, dedup):
    indptr, indices = _graph()
    feat = _table()
    dedup_cold, budget = DEDUP[dedup]
    rows = N if kind == "hbm" else 50
    kw = dict(device_cache_size=rows * DIM * 4, dedup_cold=dedup_cold,
              cold_budget=budget)
    j = qv.Feature(csr_topo=qv.CSRTopo(indptr=indptr, indices=indices),
                   **kw)
    j.from_cpu_tensor(feat)
    t = Feature(csr_topo=CSRTopo(indptr=indptr, indices=indices,
                                 device="cpu"),
                host_placement="numpy" if kind == "numpy" else "offload",
                device="cpu", **kw).from_cpu_tensor(feat)
    return j, t


def _lookup_ids(masked):
    g = np.random.default_rng(3)
    pool = g.choice(N, 12, replace=False)
    ids = g.choice(pool, 64).astype(np.int32)
    if masked:
        ids[g.choice(64, 9, replace=False)] = -1
    return ids


@pytest.mark.parametrize("dedup", list(DEDUP))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["offload", "numpy", "hbm"])
def test_lookup_counters_equal_jax(kind, masked, dedup):
    j, t = _lookup_stores(kind, dedup)
    ids = _lookup_ids(masked)
    rows, got = t.lookup_tiered(ids, masked=masked, collect_metrics=True)
    if kind == "offload":
        host = jquant.tree_map_tier(jnp.asarray, j.host_part)
        _, want = _jax(j._lookup_tiered, j.device_part, host,
                       jnp.asarray(ids), j.feature_order, masked, True)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
    else:
        _, want = _jax(j.lookup_tiered, ids, masked=masked,
                       collect_metrics=True)
    assert np.array_equal(_vec(got), np.asarray(want)), (
        metrics.counters_dict(got), jm.counters_dict(want))
    assert torch.equal(rows, t.lookup_tiered(ids, masked=masked))
    c = _vec(got)
    assert c[metrics.LOOKUP_CALLS] == 1
    assert c[metrics.HOT_ROWS] + c[metrics.COLD_ROWS] \
        == int((ids >= 0).sum())
    if kind == "offload" and dedup in ("narrow", "overflow"):
        assert c[metrics.DEDUP_CALLS] == 1
        assert c[metrics.DEDUP_OVERFLOW] == (dedup == "overflow")


def test_lookup_counters_without_a_hot_tier():
    """No hot tier: every slot is cold, and ``dedup_take`` records."""
    indptr, indices = _graph()
    feat = _table()
    j = qv.Feature(device_cache_size=0, dedup_cold=True, cold_budget=16,
                   csr_topo=qv.CSRTopo(indptr=indptr, indices=indices))
    j.from_cpu_tensor(feat)
    t = Feature(device_cache_size=0, dedup_cold=True, cold_budget=16,
                csr_topo=CSRTopo(indptr=indptr, indices=indices,
                                 device="cpu"),
                host_placement="offload", device="cpu").from_cpu_tensor(feat)
    assert t.device_part is None
    ids = _lookup_ids(False)
    rows, got = t.lookup_tiered(ids, collect_metrics=True)
    _, want = _jax(j._lookup_tiered, None,
                   jquant.tree_map_tier(jnp.asarray, j.host_part),
                   jnp.asarray(ids), j.feature_order, False, True)
    assert np.array_equal(_vec(got), np.asarray(want))
    assert _vec(got)[metrics.DEDUP_CALLS] == 1
    assert torch.equal(rows, t[ids])


# -- the train steps ----------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    indptr, indices = _graph(seed=11)
    g = np.random.default_rng(11)
    seeds = np.concatenate([[0, 4], g.choice(np.arange(6, N), 4,
                                             replace=False),
                            [-1, -1]]).astype(np.int32)
    labels = g.integers(0, OUT, BS).astype(np.int32)
    return dict(indptr=indptr, indices=indices, feat=_table(seed=12),
                seeds=seeds, labels=labels)


def _flax(sizes):
    fmodel = FlaxSAGE(hidden_dim=HIDDEN, out_dim=OUT, num_layers=len(sizes),
                      dropout=0.0)
    layers, cur = [], jnp.full((BS,), -1, jnp.int32)
    for k in sizes:
        layers.append(jsample.compact_layer(
            cur, jnp.full((cur.shape[0], k), -1, jnp.int32),
            seeds_dense=True))
        cur = layers[-1].n_id
    tx = optax.adam(1e-3)
    state = jtrain.init_state(fmodel, tx, jnp.zeros((cur.shape[0], DIM)),
                              jtrain.layers_to_adjs(layers, BS, sizes),
                              jax.random.key(0))
    return fmodel, tx, state


def _port_state(jstate, sizes):
    model = GraphSAGE(DIM, HIDDEN, OUT, len(sizes), dropout=0.0)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    return model, opt


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("sizes", [[4], [3, 2]], ids=str)
def test_fused_train_counters_equal_jax(data, sizes, kind):
    fmodel, tx, jstate = _flax(sizes)
    jstep = jtrain.build_train_step(
        fmodel, tx, sizes, BS, fused_hot_hop=True, fused_row_cap=ROW_CAP,
        fused_rng="hash", fused_interpret=True, donate=False,
        collect_metrics=True)
    feat = quantize(data["feat"], "int8") if kind == "int8" \
        else torch.from_numpy(data["feat"])
    jfeat = jquant.quantize(jnp.asarray(data["feat"]), "int8") \
        if kind == "int8" else jnp.asarray(data["feat"])
    key = jax.random.key(42)
    _, jloss, want = _jax(jstep, jstate, jfeat, None,
                          *(jnp.asarray(data[k]) for k in
                            ("indptr", "indices", "seeds", "labels")), key)
    hop_seeds = [int(jfused._hop_seed(key, i)) for i in range(len(sizes))]
    args = [feat, None] + [torch.from_numpy(data[k]) for k in
                           ("indptr", "indices", "seeds", "labels")]
    outs = []
    for metered in (True, False):
        model, opt = _port_state(jstate, sizes)
        step = build_train_step(model, opt, sizes, BS, fused_hot_hop=True,
                                fused_row_cap=ROW_CAP,
                                collect_metrics=metered)
        out = step(init_state(model, opt), *args, hop_seeds, 42)
        outs.append((out, _params(model)))
    (mstate, mloss, got), mparams = outs[0]
    (_, loss), params = outs[1]
    assert np.array_equal(_vec(got), np.asarray(want))
    assert _vec(got)[metrics.FRONTIER_CAP] == BS * int(np.prod(
        [1 + k for k in sizes]))
    assert torch.equal(mloss, loss) and mstate.step == 1
    assert all(torch.equal(a, b) for a, b in zip(mparams, params))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dedup_gather", [None, True, 4])
def test_split_train_counters(data, dedup_gather):
    """The split route samples from a torch generator: the frontier
    counters are the port's own count, the cap JAX's formula, the dedup
    gather's statistics the unique count of the frontier."""
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    args = [torch.from_numpy(data["feat"]), None] + [
        torch.from_numpy(data[k]) for k in
        ("indptr", "indices", "seeds", "labels")]
    outs = []
    for metered in (True, False):
        model, opt = _port_state(jstate, sizes)
        step = build_train_step(model, opt, sizes, BS,
                                dedup_gather=dedup_gather,
                                collect_metrics=metered)
        out = step(init_state(model, opt), *args, [7, 8], 9)
        outs.append((out, _params(model)))
    (_, mloss, got), mparams = outs[0]
    (_, loss), params = outs[1]
    assert torch.equal(mloss, loss)
    assert all(torch.equal(a, b) for a, b in zip(mparams, params))
    sample_fn, _ = build_split_train_step(_port_state(jstate, sizes)[0],
                                          None, sizes, BS)
    n_id, _ = sample_fn(args[2], args[3], args[4], 7)
    c = _vec(got)
    assert c[metrics.FRONTIER_VALID] == int((n_id >= 0).sum())
    assert c[metrics.FRONTIER_CAP] == n_id.shape[0] == BS * 4 * 3
    if dedup_gather is None:
        assert c[metrics.DEDUP_CALLS] == 0
    else:
        budget = 256 if dedup_gather is True else dedup_gather
        uniq = int(torch.unique(n_id[n_id >= 0]).numel())
        assert c[metrics.DEDUP_CALLS] == (budget < n_id.shape[0])
        assert c[metrics.DEDUP_TOTAL] == c[metrics.FRONTIER_VALID] \
            * (budget < n_id.shape[0])
        assert c[metrics.DEDUP_UNIQUE] == uniq * (budget < n_id.shape[0])
        assert c[metrics.DEDUP_OVERFLOW] == (uniq > budget
                                             and budget < n_id.shape[0])


# -- serving ------------------------------------------------------------------

CAP = 8


@pytest.mark.parametrize("placement", ["offload", "numpy"])
@pytest.mark.parametrize("dedup_cold", [True, 6])
def test_tiered_engine_counters_equal_jax(data, placement, dedup_cold):
    """The fused tiered engine: the walk's frontier counters and the
    store's lookup absorbed, as JAX's; hot slots reach the store as -1,
    so the lookup counts 0 hot rows, in JAX too."""
    sizes = [3, 2]
    fmodel, _, jstate = _flax(sizes)
    variables = jstate.params
    indptr, indices = data["indptr"], data["indices"]
    kw = dict(device_cache_size=80 * (DIM + 8), dedup_cold=dedup_cold,
              dtype_policy="int8")
    jstore = qv.Feature(csr_topo=qv.CSRTopo(indptr=indptr, indices=indices),
                        **kw)
    jstore.from_cpu_tensor(data["feat"])
    store = Feature(csr_topo=CSRTopo(indptr=indptr, indices=indices,
                                     device="cpu"),
                    host_placement=placement, device="cpu", **kw) \
        .from_cpu_tensor(data["feat"])
    jeng = JServeEngine(fmodel, variables, qv.CSRTopo(indptr=indptr,
                                                      indices=indices),
                        jstore, [sizes], CAP, fused_hot_hop=True,
                        fused_row_cap=ROW_CAP, collect_metrics=True, seed=5)
    seeds = np.array([3, 7, 11, 150, 42], np.int32)
    _jax(jeng.run, seeds)
    want = np.asarray(jeng.last_counters)
    _, sub = jax.random.split(jax.random.key(5))
    hop_seeds = [int(jfused._hop_seed(sub, i)) for i in range(len(sizes))]

    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    mk = lambda metered: ServeEngine(
        GraphSAGE(DIM, HIDDEN, OUT, len(sizes), dropout=0.0), state,
        (indptr, indices), store, [sizes], CAP, fused_hot_hop=True,
        fused_row_cap=ROW_CAP, collect_metrics=metered, device="cpu")
    eng = mk(True)
    got_logits = eng.run(seeds, hop_seeds=hop_seeds)
    got = _vec(eng.last_counters)
    assert np.array_equal(got, want), (metrics.counters_dict(got),
                                       jm.counters_dict(want))
    assert got[metrics.HOT_ROWS] == 0 and got[metrics.COLD_ROWS] > 0
    assert got[metrics.DEDUP_CALLS] == (dedup_cold is not True)
    assert torch.equal(got_logits, mk(False).run(seeds, hop_seeds=hop_seeds))


@pytest.mark.parametrize("route", ["split", "split_store", "dedup_gather"])
def test_split_engine_counters(data, route):
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      jstate.params))
    topo = (data["indptr"], data["indices"])
    feat, kw = data["feat"], {}
    if route == "split_store":
        feat = Feature(device_cache_size=80 * DIM * 4, dedup_cold=True,
                       cold_budget=16, host_placement="offload",
                       csr_topo=CSRTopo(indptr=data["indptr"],
                                        indices=data["indices"],
                                        device="cpu"),
                       device="cpu").from_cpu_tensor(data["feat"])
    if route == "dedup_gather":
        kw = dict(dedup_gather=16)
    mk = lambda metered: ServeEngine(
        GraphSAGE(DIM, HIDDEN, OUT, len(sizes), dropout=0.0), state, topo,
        feat, [sizes], CAP, collect_metrics=metered, device="cpu", **kw)
    eng = mk(True)
    seeds = np.array([3, 7, 11, 150, 42], np.int32)
    logits = eng.run(seeds, hop_seeds=[5, 6])
    assert torch.equal(logits, mk(False).run(seeds, hop_seeds=[5, 6]))
    c = _vec(eng.last_counters)
    n_id, _ = sample_multihop_serving(
        eng._indptr, eng._indices, eng.pad_seeds(seeds), sizes,
        torch.Generator().manual_seed(5))
    assert c[metrics.FRONTIER_VALID] == int((n_id >= 0).sum())
    assert c[metrics.FRONTIER_CAP] == n_id.shape[0]
    if route == "split_store":
        _, vec = feat.lookup_tiered(n_id, masked=True, collect_metrics=True)
        want = _vec(vec)
        for s in (metrics.LOOKUP_CALLS, metrics.HOT_ROWS, metrics.COLD_ROWS,
                  metrics.DEDUP_CALLS, metrics.DEDUP_TOTAL,
                  metrics.DEDUP_UNIQUE, metrics.DEDUP_OVERFLOW):
            assert c[s] == want[s]
        assert c[metrics.LOOKUP_CALLS] == 1 and c[metrics.HOT_ROWS] > 0
    elif route == "dedup_gather":
        uniq = int(torch.unique(n_id[n_id >= 0]).numel())
        assert c[metrics.DEDUP_CALLS] == 1
        assert c[metrics.DEDUP_UNIQUE] == uniq
        assert c[metrics.DEDUP_OVERFLOW] == (uniq > 16)
    else:
        assert c[metrics.LOOKUP_CALLS] == c[metrics.DEDUP_CALLS] == 0


# -- the sampler --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["HBM", "HOST"])
@pytest.mark.parametrize("sampling", ["exact", "rotation"])
def test_sampler_counters(data, mode, sampling):
    sizes = [3, 2]
    indptr, indices = data["indptr"], data["indices"]
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    mk = lambda metered: GraphSageSampler(
        topo, sizes, device="cpu", mode=mode, sampling=sampling, seed=3,
        collect_metrics=metered)
    sampler, plain = mk(True), mk(False)
    assert sampler.last_counters is None
    seeds = np.arange(6, dtype=np.int32)
    n_id, bs, adjs = sampler.sample(seeds)
    n_id2, _, adjs2 = plain.sample(seeds)
    assert torch.equal(n_id, n_id2) and plain.last_counters is None
    assert all(torch.equal(a.edge_index, b.edge_index)
               for a, b in zip(adjs, adjs2))
    c = _vec(sampler.last_counters)
    js = JSampler(qv.CSRTopo(indptr=indptr, indices=indices), sizes,
                  sampling=sampling, collect_metrics=True)
    jn_id, _, _ = _jax(js.sample, seeds)
    want = np.asarray(js.last_counters)
    assert c[metrics.FRONTIER_CAP] == want[jm.FRONTIER_CAP] \
        == jn_id.shape[0] == n_id.shape[0]
    assert c[metrics.FRONTIER_VALID] == int((n_id >= 0).sum())
    assert metrics.derive(c)["frontier_fill"] == \
        c[metrics.FRONTIER_VALID] / c[metrics.FRONTIER_CAP]
    assert c.sum() == c[metrics.FRONTIER_VALID] + c[metrics.FRONTIER_CAP]
