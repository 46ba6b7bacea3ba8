"""The port's ``MicroBatchServer`` (``quiver_tpu_torch/serving.py``)
against the JAX package's (``quiver_tpu/serving.py``) on the CPU.

The world is ``tests/test_serving.py``'s: 400 nodes, 8-dim features,
every degree 1..3 below the fanout 4, so a full-fanout row does not
depend on the sampler's draws, the ladder ``[[4, 4], [1, 1]]`` and
``batch_cap`` 8. The flax parameters carry across with
``models.convert.flax_to_state_dict``.

**Differential.** The same request sequences are staged (``start=False``)
into a JAX server over JAX's ``ServeEngine`` and a port server over the
port's ``ServeEngine(device="cpu")``, on the fused route (the kernels'
plain versions; the port's engine replays the per-hop seeds JAX derives
from its key, so shed batches draw the same picks) and on the split
route (whose samplers draw from different generators: there, rows of
shed batches are held to the port engine's replay of the batch). Every
request's outcome, the batches' seed blocks and variants, the
``serving`` counters, the tenant counters and ``health()`` must be
equal, and rows within rtol 1e-5 / atol 1e-6 (the models sum in another
order).

**Contracts.** Every ``MicroBatchServer`` contract of
``tests/test_serving.py`` (coalescing, overload and shedding, spans and
SLO, life cycle, tenancy), the fault sites of ``tests/test_faults.py``
and the knobs of ``tests/test_actuator.py``, on the port alone. The
port's steps run eagerly, so no ``recompiles`` field appears (nothing
to watch: ``ServeEngine.jitted_fns`` is empty). Wall-clock bounds are
JAX's."""

import json
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops import sample_multihop as jsample_multihop
from quiver_tpu.ops.pallas.fused import _hop_seed
from quiver_tpu.parallel.train import (init_state, layers_to_adjs,
                                       masked_feature_gather)

import quiver_tpu_torch as qt
from quiver_tpu_torch import faults as qfaults
from quiver_tpu_torch import metrics as qm
from quiver_tpu_torch import tracing
from quiver_tpu_torch.faults import FaultPlan, FaultRule
from quiver_tpu_torch.models import flax_to_state_dict

N, DIM, CLASSES = 400, 8, 3
CAP = 8
FULL, SHED = [4, 4], [1, 1]
KEY = 123                    # the key both packages' chains restart from


@pytest.fixture(scope="module")
def world():
    """``tests/test_serving.py``'s world: max degree 3 < fanout 4."""
    rng = np.random.default_rng(7)
    deg = rng.integers(1, 4, N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N, int(indptr[-1]), dtype=np.int32)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    model = FlaxSAGE(hidden_dim=8, out_dim=CLASSES, num_layers=2,
                     dropout=0.0)
    ij = jnp.asarray(indptr.astype(np.int32))
    xj = jnp.asarray(indices)
    n_id, layers = jsample_multihop(ij, xj, jnp.arange(4, dtype=jnp.int32),
                                    FULL, jax.random.key(0))
    state = init_state(model, optax.adam(1e-3),
                       masked_feature_gather(jnp.asarray(feat), n_id),
                       layers_to_adjs(layers, 4, FULL), jax.random.key(1))
    return dict(model=model, params=state.params, ij=ij, xj=xj,
                indptr=indptr, indices=indices, feat=feat,
                state_dict=flax_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, state.params)))


def _port_engine(world, variants=(FULL, SHED), **kw):
    model = qt.GraphSAGE(DIM, 8, CLASSES, 2, dropout=0.0)
    return qt.ServeEngine(model, world["state_dict"],
                          (world["indptr"], world["indices"]),
                          world["feat"], [list(v) for v in variants], CAP,
                          device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(world):
    return _port_engine(world).warmup()


@pytest.fixture(scope="module")
def reference(engine):
    """Direct per-node full-fanout logits (draw-independent, see above)."""
    return {v: engine.run(np.array([v], np.int32))[0].numpy()
            for v in range(64)}


# ---------------------------------------------------------------------------
# the differential: the same staged traffic through both servers
# ---------------------------------------------------------------------------


class _Recorder:
    """An engine as the server sees it, recording every dispatch's
    ``(seeds, variant, hop_seeds)``. ``seeds_from`` picks the per-hop
    seeds: None (JAX's engine keeps its own key chain), ``"jax"`` (the
    port's fused route runs each batch on the seeds JAX's engine derives
    from its chain: ``key, sub = split(key)``, hop ``i`` seeded
    ``_hop_seed(sub, i)``) or ``"draw"`` (the port engine's own
    generator, drawn here so the batch can be replayed)."""

    def __init__(self, eng, seeds_from=None):
        self._eng = eng
        self.seeds_from = seeds_from
        self.key = jax.random.key(KEY)
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def run(self, seeds, variant=0):
        hops = len(self._eng.variants[variant])
        hs = None
        if self.seeds_from == "jax":
            self.key, sub = jax.random.split(self.key)
            hs = [int(_hop_seed(sub, i)) for i in range(hops)]
        elif self.seeds_from == "draw":
            hs = self._eng.draw_hop_seeds(hops)
        out = self._eng.run(seeds, variant) if hs is None else \
            self._eng.run(seeds, variant, hop_seeds=hs)
        self.calls.append((np.asarray(seeds).copy(), int(variant), hs,
                           np.array(out)))
        return out


@pytest.fixture(scope="module", params=["fused", "split"])
def engines(request, world):
    fused = request.param == "fused"
    w = world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # JAX pads D=8 to 128 lanes
        jeng = qv.ServeEngine(w["model"], w["params"], (w["ij"], w["xj"]),
                              w["feat"], sizes_variants=[FULL, SHED],
                              batch_cap=CAP, fused_hot_hop=fused).warmup()
    return request.param, jeng, _port_engine(w, fused_hot_hop=fused).warmup()


def _stage(srv, plan):
    """Submit ``plan`` (``(node, tenant, expired)`` triples) to a paused
    server; an admission refusal is the request's outcome."""
    out = []
    for node, tenant, expired in plan:
        dl = time.perf_counter() - 0.01 if expired else None
        try:
            out.append(srv.submit(node, deadline=dl, tenant=tenant))
        except (qv.OverloadError, qt.OverloadError) as e:
            out.append(type(e).__name__)
    return out


def _outcome(f):
    """A request's row, or the name of its error (a refusal at the door
    is already a name)."""
    if isinstance(f, str):
        return f
    try:
        return np.asarray(f.result(timeout=60))
    except RuntimeError as e:      # OverloadError, ServerClosed, RpcError
        return type(e).__name__


def _serve(pkg, eng, cfg_kw, tenants, plan):
    tc = (pkg.default_tenant_classes() if tenants else None)
    srv = pkg.MicroBatchServer(eng, pkg.ServeConfig(**cfg_kw), start=False,
                               tenants=tc)
    try:
        staged = _stage(srv, plan)
        srv.start()
        outs = [_outcome(f) for f in staged]
        snap = srv.snapshot()["serving"]
        tens = srv.tenant_snapshots()
        health = srv.health()
    finally:
        srv.close()
    return outs, snap, tens, health


def _dups(n):
    """``n`` distinct ids with a duplicate of every fifth right after
    it: the duplicates land in their original's batch."""
    out = []
    for i in range(n):
        out.append(i)
        if i % 5 == 0 and (i + 1) % CAP:
            out.append(i)
    return [(i, None, False) for i in out]


# name -> (config, tenants?, plan); max_wait is generous so that staged
# batches fill to the cap on any host
SCENARIOS = {
    "burst": (dict(max_wait_ms=200.0, queue_depth=64,
                   shed_queue_frac=1.0), False, _dups(2 * CAP + 3)),
    "pressure": (dict(max_wait_ms=200.0, queue_depth=64,
                      shed_queue_frac=0.05, calm_batches=2), False,
                 [(i % 16, None, False) for i in range(48)]),
    "overload_deadline": (dict(max_wait_ms=200.0, queue_depth=5,
                               shed_queue_frac=1.0), False,
                          [(3, None, False), (9, None, True),
                           (4, None, False), (4, None, False),
                           (7, None, True), (11, None, False),
                           (12, None, False)]),
    "tenant_shares": (dict(max_wait_ms=200.0, queue_depth=7,
                           shed_queue_frac=0.3, calm_batches=100), True,
                      [(0, "best_effort", False), (1, "best_effort", False),
                       (2, "best_effort", False), (3, "interactive", False),
                       (4, "batch", False), (5, None, False),
                       (6, "interactive", True), (7, "interactive", False)]),
    "tenant_displace": (dict(max_wait_ms=200.0, queue_depth=3,
                             shed_queue_frac=1.0), True,
                        [(0, "best_effort", False), (1, "best_effort", False),
                         (2, "best_effort", False), (3, "interactive", False),
                         (4, "batch", False), (5, "best_effort", False),
                         (6, "interactive", False)]),
    "tenant_class_pure": (dict(max_wait_ms=200.0, queue_depth=64,
                               shed_queue_frac=0.05, calm_batches=3), True,
                          [(i % 24, t, False) for i in range(40)
                           for t in (("interactive", "best_effort",
                                      "batch")[i % 3],)]),
}


def _tenant_counts(recs):
    keys = ("tenant", "priority", "admission_weight", "shed_grace",
            "queued", "shed", "requests", "completed", "rejected",
            "displaced", "deadline_expired", "failed")
    return [dict({k: r[k] for k in keys}, n=r["latency"]["n"])
            for r in recs]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_matches_jax(engines, name):
    route, jeng, peng = engines
    cfg, tenants, plan = SCENARIOS[name]
    jrec = _Recorder(jeng)
    prec = _Recorder(peng, "jax" if route == "fused" else "draw")
    jeng._key = jax.random.key(KEY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_out, j_snap, j_ten, j_health = _serve(qv, jrec, cfg, tenants, plan)
    p_out, p_snap, p_ten, p_health = _serve(qt, prec, cfg, tenants, plan)

    # the same batches, in order, at the same variants
    assert [(c[0].tolist(), c[1]) for c in jrec.calls] == \
        [(c[0].tolist(), c[1]) for c in prec.calls]
    n_rows = 0
    for (node, _, _), a, b in zip(plan, j_out, p_out):
        assert type(a) is type(b)
        if isinstance(a, str):
            assert a == b
            continue
        n_rows += 1
        assert b.shape == (CLASSES,)
        # the row the request's batch computed at the node's slot
        served = [(v, out[int(np.nonzero(s == node)[0][0])])
                  for s, v, _, out in prec.calls if (s == node).any()]
        assert any(np.array_equal(b, row) for _, row in served)
        if route == "fused" or all(v == 0 for v, _ in served):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    if route == "split":
        # the samplers draw from different generators, so a shed
        # batch's rows are held to the port engine's replay instead
        for s, v, hs, out in prec.calls:
            np.testing.assert_array_equal(
                peng.run(s, v, hop_seeds=hs).numpy(), out)
    assert n_rows == p_snap["completed"] > 0
    assert p_snap == j_snap
    assert _tenant_counts(p_ten) == _tenant_counts(j_ten)
    assert p_health == j_health
    if name in ("pressure", "tenant_class_pure"):
        assert p_snap["variant_batches"][1] > 0          # it did shed


# ---------------------------------------------------------------------------
# contracts on the port alone (tests/test_serving.py)
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# contracts on the port alone (tests/test_serving.py)
# ---------------------------------------------------------------------------


class TestCoalescing:
    def test_single_request_meets_deadline(self, engine, reference):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=30.0, queue_depth=16,
                                   shed_queue_frac=1.0))
        t0 = time.perf_counter()
        row = srv.submit(3).result(timeout=5)
        waited = time.perf_counter() - t0
        np.testing.assert_allclose(row, reference[3], rtol=1e-5, atol=1e-6)
        # shipped at (about) the 30 ms coalescing deadline, not at some
        # unbounded "wait for a full batch" horizon
        assert waited < 0.5
        s = srv.snapshot()["serving"]
        assert s["batches"] == 1 and s["mean_batch_fill"] == 1.0
        srv.close()

    def test_over_capacity_burst_splits(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=50.0, queue_depth=64,
                                   shed_queue_frac=1.0), start=False)
        futs = [srv.submit(i) for i in range(2 * CAP + 3)]
        srv.start()
        for f in futs:
            assert f.result(timeout=10).shape == (CLASSES,)
        s = srv.snapshot()["serving"]
        assert s["batches"] == 3                      # 8 + 8 + 3
        assert s["requests"] == s["completed"] == 2 * CAP + 3
        srv.close()

    def test_duplicate_ids_share_one_slot(self, engine, reference):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=20.0, queue_depth=64,
                                   shed_queue_frac=1.0), start=False)
        ids = [4, 9, 4, 2, 9, 4, 2, 2, 9, 4, 9, 2]   # 3 distinct: 1 batch
        futs = [srv.submit(i) for i in ids]
        srv.start()
        for i, f in zip(ids, futs):
            np.testing.assert_allclose(f.result(timeout=10), reference[i],
                                       rtol=1e-5, atol=1e-6)
        assert srv.snapshot()["serving"]["batches"] == 1
        srv.close()

    def test_scatter_under_interleaved_arrivals(self, engine, reference):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=512,
                                   shed_queue_frac=1.0))
        results, errs = {}, []
        lock = threading.Lock()

        def client(tid):
            rng = np.random.default_rng(tid)
            for k in range(40):
                nid = int(rng.integers(0, 64))
                try:
                    row = srv.submit(nid).result(timeout=20)
                except Exception as e:            # pragma: no cover
                    errs.append(e)
                    return
                with lock:
                    results[(tid, k)] = (nid, row)
                if k % 7 == 0:
                    time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errs and len(results) == 160
        for nid, row in results.values():
            np.testing.assert_allclose(row, reference[nid], rtol=1e-5,
                                       atol=1e-6)
        srv.close()

    def test_each_batch_owns_its_rows(self, engine):
        # the readback gives every batch a host array of its own: rows
        # of one batch are never views into another's
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=64,
                                   shed_queue_frac=1.0), start=False)
        futs = [srv.submit(i) for i in range(2 * CAP)]
        srv.start()
        rows = [f.result(timeout=10) for f in futs]
        first = [r.copy() for r in rows[:CAP]]
        srv.submit(3).result(timeout=10)
        srv.close()
        assert not np.shares_memory(rows[0], rows[CAP])
        assert all(np.array_equal(a, b) for a, b in zip(first, rows[:CAP]))


class TestOverloadAndShedding:
    def test_admission_overload_raises(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=5.0, queue_depth=2),
            start=False)
        f1, f2 = srv.submit(0), srv.submit(1)
        with pytest.raises(qt.OverloadError, match="queue full"):
            srv.submit(2)
        srv.start()
        assert f1.result(timeout=10) is not None
        assert f2.result(timeout=10) is not None
        s = srv.snapshot()["serving"]
        assert s["rejected"] == 1 and s["requests"] == 2
        srv.close()

    def test_submit_many_carries_admitted_futures(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=5.0, queue_depth=3),
            start=False)
        with pytest.raises(qt.OverloadError) as ei:
            srv.submit_many(range(5))
        assert len(ei.value.futures) == 3
        srv.start()
        for f in ei.value.futures:
            assert f.result(timeout=10).shape == (CLASSES,)
        srv.close()

    def test_queue_pressure_sheds_to_smaller_fanout(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=64,
                                   shed_queue_frac=0.05), start=False)
        futs = [srv.submit(i % 16) for i in range(48)]
        srv.start()
        for f in futs:
            row = f.result(timeout=20)
            assert row.shape == (CLASSES,) and np.isfinite(row).all()
        s = srv.snapshot()["serving"]
        assert s["variant_batches"][1] > 0            # shed happened
        assert s["fanout_variants"] == [FULL, SHED]
        assert s["shed_level"] >= 0
        srv.close()

    def test_serving_snapshot_emits_jsonl(self, engine, tmp_path):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=64,
                                   shed_queue_frac=1.0))
        [f.result(timeout=10) for f in srv.submit_many(range(12))]
        path = tmp_path / "serving.jsonl"
        with qm.MetricsSink(str(path)) as sink:
            rec = srv.emit(sink)
        assert rec["kind"] == "serving"
        lines = [json.loads(l) for l in path.read_text().splitlines()]
        assert [l["kind"] for l in lines] == ["meta", "serving"]
        got = lines[1]
        assert got["request"]["count"] == 12          # per-REQUEST p99
        assert got["request"]["p99_ms"] > 0
        assert got["serving"]["requests"] == 12
        assert got["wall"]["p99_ms"] > 0              # per-batch too
        # eager steps: nothing to watch, so no recompiles field
        assert engine.jitted_fns == () and "recompiles" not in got
        assert "per-request latency" in srv.report()
        srv.close()

    def test_report_section_registered_while_open(self, engine):
        srv = qt.MicroBatchServer(engine, qt.ServeConfig(max_wait_ms=1.0))
        srv.submit(1).result(timeout=10)
        assert "serving: 1 requests" in qm.report()
        srv.close()
        assert "serving: 1 requests" not in qm.report()


@pytest.fixture
def traced():
    """The process tracer on for one test, off and empty afterwards."""
    tracing.clear()
    tracing.enable()
    yield tracing.get_tracer()
    tracing.disable()
    tracing.clear()


class TestTracingAndSlo:
    def test_traced_logits_bit_identical(self, world):
        # tracing is host-side only: from the same generator state the
        # served logits match bit for bit with tracing off and on
        eng = _port_engine(world, variants=[FULL], seed=11)
        seeds = np.arange(6, dtype=np.int32)
        off = eng.run(seeds)
        eng._gen.manual_seed(11)
        tracing.enable()
        try:
            on = eng.run(seeds)
        finally:
            tracing.disable()
            tracing.clear()
        assert torch.equal(off, on)

    def test_request_spans_correlate_and_nest(self, engine, traced):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=128,
                                   shed_queue_frac=1.0), start=False)
        futs = [srv.submit(i % 16) for i in range(3 * CAP)]
        srv.start()
        for f in futs:
            f.result(timeout=20)
        srv.close()
        recs = traced.records()
        by_name = {}
        for r in recs:
            by_name.setdefault(r[0], []).append(r)
        n_req = 3 * CAP
        assert len(by_name["serve.request"]) == n_req
        assert len(by_name["serve.admission_wait"]) == n_req
        assert len(by_name["serve.coalesce_wait"]) == n_req
        n_batches = len(by_name["serve.dispatch"])
        assert n_batches == len(by_name["serve.scatter"]) \
            == len(by_name["serve.batch_coalesce"]) >= 3
        batch_ids = {r[4] for r in by_name["serve.dispatch"]}
        per_req = {}
        for r in recs:
            if r[0] in ("serve.request", "serve.admission_wait",
                        "serve.coalesce_wait"):
                assert r[5]["batch"] in batch_ids
                per_req.setdefault(r[4], {})[r[0]] = r
        assert len(per_req) == n_req
        eps = 1e-4
        dispatch_t0 = {r[4]: r[2] for r in by_name["serve.dispatch"]}
        for spans in per_req.values():
            adm = spans["serve.admission_wait"]
            coa = spans["serve.coalesce_wait"]
            req = spans["serve.request"]
            assert adm[5]["batch"] == coa[5]["batch"] == req[5]["batch"]
            assert adm[2] >= req[2] - eps            # starts at enqueue
            assert adm[2] + adm[3] <= coa[2] + eps   # then coalesce
            assert coa[2] + coa[3] <= req[2] + req[3] + eps
            assert req[2] + req[3] >= dispatch_t0[req[5]["batch"]] - eps

    def test_injected_context_propagates_to_replica_trace(
            self, engine, traced, tmp_path):
        ctx = tracing.inject({"app_field": "kept"}, replica="client-7")
        client_tid = ctx[tracing.CTX_TRACE_ID]
        assert tracing.extract(ctx).replica == "client-7"
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=32,
                                   shed_queue_frac=1.0))
        with srv:
            fut = srv.submit(3, context=ctx)
            plain = srv.submit(4)            # no context: local id
            fut.result(timeout=20)
            plain.result(timeout=20)
        recs = traced.records()
        assert client_tid in {r[4] for r in recs
                              if r[0] == "serve.request"}
        names_with_ctx = {r[0] for r in recs if r[4] == client_tid}
        assert {"serve.request", "serve.admission_wait",
                "serve.coalesce_wait"} <= names_with_ctx
        out = str(tmp_path / "replica_trace.json")
        traced.export_chrome_trace(out, replica="serve-replica-0")
        doc = json.load(open(out))
        hits = [e for e in doc["traceEvents"]
                if (e.get("args") or {}).get("trace_id") == client_tid]
        assert any(e["name"] == "serve.request" for e in hits)
        procs = [e for e in doc["traceEvents"]
                 if e.get("name") == "process_name"]
        assert procs[0]["args"]["name"] == "serve-replica-0"

    def test_garbled_context_falls_back_to_local_id(self, engine, traced):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=32,
                                   shed_queue_frac=1.0))
        with srv:
            srv.submit(5, context={"qt.trace_id": "garbage"}) \
               .result(timeout=20)
        reqs = [r for r in traced.records() if r[0] == "serve.request"]
        assert reqs and all(r[4] is not None for r in reqs)

    def test_deadline_shed_leaves_an_error_span(self, engine, traced):
        srv = qt.MicroBatchServer(engine, qt.ServeConfig(max_wait_ms=1.0),
                                  start=False)
        dead = srv.submit(1, deadline=time.perf_counter() - 0.01)
        srv.start()
        with pytest.raises(qt.DeadlineExceeded):
            dead.result(timeout=10)
        srv.close()
        errs = [r for r in traced.records() if r[0] == "serve.request"
                and (r[5] or {}).get("error") == "DeadlineExceeded"]
        assert len(errs) == 1

    def test_slo_burn_rate_sheds_quality(self, engine):
        # a sub-ms p99 target makes every CPU request "bad", so later
        # batches MUST take the shed variant (queue trigger off)
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=256,
                                   shed_queue_frac=1.0,
                                   slo_p99_ms=0.001), start=False)
        futs = [srv.submit(i % 32) for i in range(120)]
        srv.start()
        for f in futs:
            assert np.isfinite(f.result(timeout=30)).all()
        s = srv.snapshot()
        assert s["serving"]["variant_batches"][1] > 0, \
            "burn-rate trigger never shed"
        assert s["slo"]["windows"]["short"]["bad"] > 0
        assert s["slo"]["budget_remaining"] < 0       # overspent
        h = srv.health()
        assert h["components"]["burn"] > 1.0 and h["score"] < 1.0
        srv.close()

    def test_slo_block_and_slo_kind_jsonl(self, engine, tmp_path):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=64,
                                   shed_queue_frac=1.0,
                                   slo_p99_ms=5000.0))
        [f.result(timeout=10) for f in srv.submit_many(range(25))]
        path = tmp_path / "slo.jsonl"
        with qm.MetricsSink(str(path)) as sink:
            rec = srv.emit(sink)                      # kind serving
            srv.slo.emit(sink)                        # kind slo
        assert rec["slo"]["target_p99_ms"] == 5000.0
        lines = [json.loads(l) for l in path.read_text().splitlines()]
        assert [l["kind"] for l in lines] == ["meta", "serving", "slo"]
        assert lines[1]["slo"]["total"]["requests"] == 25
        assert lines[2]["target_p99_ms"] == 5000.0
        assert "burn_rate" in lines[2]["windows"]["short"]
        assert not lines[2]["shedding"]
        report = srv.report()
        assert "slo:" in report and "budget remaining" in report
        srv.close()

    def test_no_slo_budget_without_target(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=16,
                                   shed_queue_frac=1.0))
        assert srv.slo is None
        srv.submit(1).result(timeout=10)
        assert "slo" not in srv.snapshot()
        assert srv.health() == {"score": 1.0, "components": {
            "stale": False, "burn": None, "burn_penalty": 0.0,
            "shed_frac": 0.0, "shed_penalty": 0.0}}
        srv.close()

    def test_health_score_matches_jax(self):
        from quiver_tpu.fleet import health_score as jhealth
        from quiver_tpu_torch.serving import health_score
        for kw in ({}, {"burn": 0.5}, {"burn": 1.5, "shed_frac": 0.5},
                   {"burn": 7.0, "shed_frac": 1.0}, {"stale": True},
                   {"burn": None, "shed_frac": 0.25, "age_s": 3.21}):
            assert health_score(**kw) == jhealth(**kw)


class TestLifecycle:
    def test_close_fails_queued_requests_loudly(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=5.0, queue_depth=16),
            start=False)
        futs = [srv.submit(i) for i in range(3)]
        srv.close()
        for f in futs:
            with pytest.raises(RuntimeError, match="closed"):
                f.result(timeout=5)
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(0)
        srv.close()                                   # idempotent
        assert srv.closed

    def test_close_fails_pipeline_queued_batch(self, engine, monkeypatch):
        # batch A held on the executor while batch B sits QUEUED in the
        # pipeline; close() must fail B's futures, never strand them
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=50.0, queue_depth=64,
                                   shed_queue_frac=1.0), start=False)
        real_run = engine.run
        started, release = threading.Event(), threading.Event()

        def held_run(seeds, variant=0):
            started.set()
            assert release.wait(timeout=30)
            return real_run(seeds, variant)

        monkeypatch.setattr(engine, "run", held_run)
        futs = [srv.submit(i) for i in range(2 * CAP)]   # two full batches
        srv.start()
        assert started.wait(timeout=10)       # A is on the executor
        deadline = time.perf_counter() + 5    # B coalesced + queued
        while srv._q.qsize() > 0 and time.perf_counter() < deadline:
            time.sleep(0.005)
        closer = threading.Thread(target=srv.close)
        closer.start()                        # blocks on A's join
        time.sleep(0.05)
        release.set()                         # let A drain
        closer.join(timeout=30)
        assert not closer.is_alive()
        ok = failed = 0
        for f in futs:
            try:
                f.result(timeout=5)
                ok += 1
            except RuntimeError:
                failed += 1
        assert ok == CAP and failed == CAP    # A served, B failed loudly
        assert srv.snapshot()["serving"]["failed"] == CAP

    def test_step_failure_propagates_to_request_futures(self, engine,
                                                        monkeypatch):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=16))
        calls = []

        def boom(seeds, variant=0):
            calls.append(variant)
            raise RuntimeError("device fell over")

        monkeypatch.setattr(srv.engine, "run", boom)
        fut = srv.submit(1)
        with pytest.raises(RuntimeError, match="device fell over"):
            fut.result(timeout=10)
        assert calls == [0]                   # no retry, anywhere
        monkeypatch.undo()
        # the server survives a failed batch: next request succeeds
        assert srv.submit(2).result(timeout=10).shape == (CLASSES,)
        s = srv.snapshot()["serving"]
        assert s["failed"] == 1 and s["completed"] == 1
        srv.close()

    def test_cancelled_future_is_skipped(self, engine):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=1.0, queue_depth=16),
            start=False)
        gone, kept = srv.submit(1), srv.submit(2)
        assert gone.cancel()
        srv.start()
        assert kept.result(timeout=10).shape == (CLASSES,)
        srv.close()
        assert gone.cancelled()
        assert srv.snapshot()["serving"]["completed"] == 1

    def test_start_after_close_raises(self, engine):
        srv = qt.MicroBatchServer(engine, start=False)
        srv.close()
        with pytest.raises(qt.ServerClosed):
            srv.start()


class _GateEngine:
    """A gated engine for deterministic admission tests:
    ``batch_cap=1`` makes every dispatch a single-request batch, and
    ``run`` blocks on ``gate``, so a test stages EXACT queue contents
    while the first request sits mid-dispatch. ``calls`` records every
    ``(seeds, variant)``."""

    collect_metrics = False
    jitted_fns = ()

    def __init__(self, n_variants=2):
        self.batch_cap = 1
        self.variants = [[4, 4]] + [[1, 1]] * (n_variants - 1)
        self.gate = threading.Event()
        self.gate.set()
        self.started = threading.Event()
        self.calls = []

    def run(self, seeds, variant=0):
        self.started.set()
        assert self.gate.wait(timeout=10)
        self.calls.append((np.asarray(seeds).copy(), int(variant)))
        out = torch.zeros((self.batch_cap, 2))
        out[:, 0] = torch.from_numpy(np.asarray(seeds, np.float32))
        return out


class TestTenancy:
    def test_unknown_tenant_rejected(self):
        srv = qt.MicroBatchServer(_GateEngine(),
                                  qt.ServeConfig(max_wait_ms=1.0),
                                  tenants=qt.default_tenant_classes())
        try:
            with pytest.raises(ValueError, match="unknown tenant"):
                srv.submit(1, tenant="nobody")
        finally:
            srv.close()

    def test_registry_validation(self):
        with pytest.raises(TypeError, match="TenantClass"):
            qt.MicroBatchServer(_GateEngine(), start=False,
                                tenants={"a": object()})
        with pytest.raises(ValueError, match="names a class"):
            qt.MicroBatchServer(_GateEngine(), start=False, tenants={
                "a": qt.TenantClass("b", priority=0)})
        with pytest.raises(ValueError, match="admission_weight"):
            qt.TenantClass("a", priority=0, admission_weight=0.0)
        with pytest.raises(ValueError, match="shed_grace"):
            qt.TenantClass("a", priority=0, shed_grace=-1)

    def test_tenant_ignored_without_registry(self, engine, reference):
        srv = qt.MicroBatchServer(engine, qt.ServeConfig(max_wait_ms=1.0))
        try:
            row = srv.submit(3, tenant="whoever").result(timeout=10)
        finally:
            srv.close()
        np.testing.assert_allclose(row, reference[3], rtol=1e-5, atol=1e-6)
        assert srv.tenant_snapshots() == []

    def test_none_tenant_lands_in_lowest_priority_class(self):
        srv = qt.MicroBatchServer(_GateEngine(),
                                  qt.ServeConfig(max_wait_ms=1.0),
                                  tenants=qt.default_tenant_classes())
        try:
            assert srv.submit(5).result(timeout=10)[0] == 5.0
            snaps = {t["tenant"]: t for t in srv.tenant_snapshots()}
            assert snaps["best_effort"]["requests"] == 1
            assert snaps["best_effort"]["completed"] == 1
            assert snaps["interactive"]["requests"] == 0
            assert snaps["batch"]["requests"] == 0
        finally:
            srv.close()

    def test_share_cap_rejects_flooding_class_only(self):
        # queue_depth=7, weights 4:2:1 -> shares 4 / 2 / 1; shed_at =
        # int(7 * 0.3) = 2: best_effort past its share is shed at the
        # door while interactive still admits
        eng = _GateEngine()
        eng.gate.clear()
        srv = qt.MicroBatchServer(
            eng, qt.ServeConfig(max_wait_ms=0.5, queue_depth=7,
                                shed_queue_frac=0.3, calm_batches=100),
            tenants=qt.default_tenant_classes())
        try:
            futs = [srv.submit(0, tenant="best_effort")]
            assert eng.started.wait(timeout=10)
            futs += [srv.submit(i, tenant="best_effort") for i in (1, 2)]
            with pytest.raises(qt.OverloadError, match="holds its share"):
                srv.submit(3, tenant="best_effort")
            futs.append(srv.submit(4, tenant="interactive"))
            eng.gate.set()
            assert [f.result(timeout=10)[0] for f in futs] == \
                [0.0, 1.0, 2.0, 4.0]
            snaps = {t["tenant"]: t for t in srv.tenant_snapshots()}
            be = snaps["best_effort"]
            assert be["rejected"] == 1 and be["shed"] == 1
            assert be["requests"] == 3 and be["completed"] == 3
            ia = snaps["interactive"]
            assert ia["rejected"] == 0 and ia["completed"] == 1
        finally:
            eng.gate.set()
            srv.close()

    def test_displacement_evicts_newest_lowest_priority(self):
        eng = _GateEngine()
        eng.gate.clear()
        srv = qt.MicroBatchServer(
            eng, qt.ServeConfig(max_wait_ms=0.5, queue_depth=2,
                                shed_queue_frac=1.0, calm_batches=100),
            tenants=qt.default_tenant_classes())
        try:
            f0 = srv.submit(0, tenant="best_effort")
            assert eng.started.wait(timeout=10)
            f1 = srv.submit(1, tenant="best_effort")
            f2 = srv.submit(2, tenant="best_effort")   # newest queued
            f3 = srv.submit(3, tenant="interactive")
            with pytest.raises(qt.OverloadError, match="displaced"):
                f2.result(timeout=5)
            eng.gate.set()
            assert f0.result(timeout=10)[0] == 0.0
            assert f1.result(timeout=10)[0] == 1.0
            assert f3.result(timeout=10)[0] == 3.0
            snaps = {t["tenant"]: t for t in srv.tenant_snapshots()}
            be = snaps["best_effort"]
            assert be["displaced"] == 1 and be["shed"] == 1
            assert be["completed"] == 2
            assert snaps["interactive"]["completed"] == 1
            # a best_effort submit into the full queue must NOT displace
            # its own class (no strictly-lower priority left)
            eng.gate.clear()
            eng.started.clear()
            g0 = srv.submit(0, tenant="best_effort")
            assert eng.started.wait(timeout=10)
            g1 = srv.submit(1, tenant="interactive")
            g2 = srv.submit(2, tenant="interactive")
            with pytest.raises(qt.OverloadError, match="queue full"):
                srv.submit(3, tenant="best_effort")
            eng.gate.set()
            for g in (g0, g1, g2):
                assert g.result(timeout=10) is not None
        finally:
            eng.gate.set()
            srv.close()

    def test_shed_grace_orders_quality_shed(self):
        eng = _GateEngine(n_variants=2)
        srv = qt.MicroBatchServer(
            eng, qt.ServeConfig(max_wait_ms=0.5, queue_depth=64,
                                shed_queue_frac=1.0, calm_batches=10_000),
            tenants=qt.default_tenant_classes())
        try:
            srv._shed_level = 1
            for nid, t in ((7, "interactive"), (8, "best_effort"),
                           (9, "batch")):
                assert srv.submit(nid, tenant=t).result(timeout=10)[0] \
                    == float(nid)
            # interactive: grace 8 swallows the step -> 0; best_effort:
            # grace 0 -> 1; batch: grace 1 -> 0
            assert [v for _, v in eng.calls] == [0, 1, 0]
        finally:
            srv.close()

    def test_shed_floor_lower_bounds_every_class(self):
        eng = _GateEngine(n_variants=2)
        srv = qt.MicroBatchServer(
            eng, qt.ServeConfig(max_wait_ms=0.5, queue_depth=64,
                                shed_queue_frac=1.0),
            tenants=qt.default_tenant_classes())
        try:
            srv.set_shed_floor(1)
            srv.submit(7, tenant="interactive").result(timeout=10)
            srv.set_shed_floor(0)
            srv.submit(8, tenant="interactive").result(timeout=10)
            assert [v for _, v in eng.calls] == [1, 0]
        finally:
            srv.close()

    def test_tenant_snapshots_and_jsonl(self, engine, tmp_path):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=64,
                                   shed_queue_frac=1.0),
            tenants=qt.default_tenant_classes(slo_p99_ms=200.0))
        try:
            futs = [srv.submit(i, tenant=t)
                    for t, k in (("interactive", 3), ("batch", 2),
                                 ("best_effort", 1))
                    for i in range(k)]
            for f in futs:
                assert f.result(timeout=10) is not None
            path = tmp_path / "tenants.jsonl"
            with qm.MetricsSink(str(path)) as sink:
                recs = srv.emit_tenants(sink)
            assert "tenant interactive: 3 requests" in srv.report()
        finally:
            srv.close()
        by = {r["tenant"]: r for r in recs}
        assert sorted(by) == sorted(qt.serving.TENANT_CLASS_NAMES)
        for name, n in (("interactive", 3), ("batch", 2),
                        ("best_effort", 1)):
            r = by[name]
            assert r["requests"] == n and r["completed"] == n
            assert r["shed"] == 0 and r["queued"] == 0
            assert r["latency"]["n"] == n and r["latency"]["p99_ms"] > 0
        assert by["interactive"]["slo"]["target_p99_ms"] == 200.0
        assert by["batch"]["slo"]["target_p99_ms"] == 800.0
        assert "slo" not in by["best_effort"]
        lines = [json.loads(l) for l in path.read_text().splitlines()]
        assert [l["kind"] for l in lines] == \
            ["meta", "tenant", "tenant", "tenant"]

    def test_logits_bit_identical_with_tenancy(self, world):
        # tenancy is host-side accounting and queue discipline only:
        # from the same generator state, calm traffic yields the same
        # bytes with the registry on and off
        eng = _port_engine(world, seed=13)
        plan = ((3, "interactive"), (9, "batch"), (14, "best_effort"),
                (21, None))
        rows = {}
        for tenants in (None, qt.default_tenant_classes()):
            eng._gen.manual_seed(13)
            srv = qt.MicroBatchServer(
                eng, qt.ServeConfig(max_wait_ms=1.0, queue_depth=64,
                                    shed_queue_frac=1.0),
                tenants=tenants)
            try:
                for nid, tenant in plan:
                    row = srv.submit(nid, tenant=tenant).result(timeout=10)
                    rows.setdefault(nid, []).append(row)
            finally:
                srv.close()
        for nid, (off, on) in rows.items():
            assert off.tobytes() == on.tobytes(), nid


# ---------------------------------------------------------------------------
# the fault sites (tests/test_faults.py) and the knobs
# (tests/test_actuator.py)
# ---------------------------------------------------------------------------


class TestServeFaults:
    def test_execute_fault_fails_batch_server_survives(self, engine):
        srv = qt.MicroBatchServer(engine, qt.ServeConfig(max_wait_ms=1.0))
        qfaults.install(FaultPlan(rules={
            "serve.execute": FaultRule("error", exc="runtime", times=1)}))
        try:
            fut = srv.submit(1)
            with pytest.raises(RuntimeError, match="injected"):
                fut.result(timeout=30)
            ok = srv.submit(2)
            assert ok.result(timeout=30).shape == (CLASSES,)
        finally:
            qfaults.disarm()
            srv.close()

    def test_coalescer_death_fails_queued_fast_and_rejects(self, engine):
        srv = qt.MicroBatchServer(engine, qt.ServeConfig(max_wait_ms=1.0),
                                  start=False)
        staged = [srv.submit(i) for i in range(4)]
        qfaults.install(FaultPlan(rules={
            "serve.coalesce": FaultRule("error", exc="runtime")}))
        try:
            srv.start()
            for f in staged:
                with pytest.raises(qt.ServerClosed):
                    f.result(timeout=10)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not srv._broken:
                time.sleep(0.01)
            with pytest.raises(qt.ServerClosed):
                srv.submit(99)
            assert srv.health()["score"] == 0.0
            assert srv.snapshot()["serving"]["failed"] == 4
        finally:
            qfaults.disarm()
            srv.close()

    def test_submit_racing_close_gets_server_closed(self, engine):
        srv = qt.MicroBatchServer(engine, qt.ServeConfig())
        stop = threading.Event()
        errs = []

        def hammer():
            i = 0
            while not stop.is_set():
                try:
                    srv.submit(i % N)
                except qt.ServerClosed:
                    errs.append("closed")
                    return
                except qt.OverloadError:
                    pass
                i += 1

        t = threading.Thread(target=hammer)
        t.start()
        time.sleep(0.05)
        srv.close()
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        with pytest.raises(qt.ServerClosed):
            srv.submit(0)


class TestServerKnobs:
    def test_knob_swaps_land_and_serve_correctly(self, engine, reference):
        srv = qt.MicroBatchServer(
            engine, qt.ServeConfig(max_wait_ms=2.0, queue_depth=64,
                                   shed_queue_frac=1.0), start=False)
        try:
            assert srv.knobs() == {"max_wait_ms": 2.0,
                                   "batch_fill_cap": CAP, "shed_floor": 0}
            for bad in (lambda: srv.set_batch_fill_cap(CAP + 1),
                        lambda: srv.set_batch_fill_cap(0),
                        lambda: srv.set_max_wait_ms(0.0),
                        lambda: srv.set_shed_floor(2)):
                with pytest.raises(ValueError):
                    bad()
            assert srv.knobs()["batch_fill_cap"] == CAP   # untouched
            srv.set_batch_fill_cap(4)
            srv.set_max_wait_ms(0.5)
            k = srv.knobs()
            assert k["batch_fill_cap"] == 4 and k["max_wait_ms"] == 0.5
            # the fill cap moves padding only: 10 staged requests go out
            # as 4 + 4 + 2 at the engine's seed width, rows unchanged (a
            # wait long enough that no batch ships short)
            srv.set_max_wait_ms(250.0)
            futs = [srv.submit(i) for i in range(10)]
            srv.start()
            for i, f in enumerate(futs):
                np.testing.assert_allclose(f.result(timeout=10),
                                           reference[i], rtol=1e-5,
                                           atol=1e-6)
            s = srv.snapshot()["serving"]
            assert s["batches"] == 3 and s["mean_batch_fill"] == 10 / 3
            srv.set_batch_fill_cap(None)          # restore
            srv.set_max_wait_ms(2.0)
            assert srv.knobs()["batch_fill_cap"] == CAP
        finally:
            srv.close()

    def test_hub_sees_every_batch(self, world):
        class Hub:
            def __init__(self):
                self.points, self.counters = [], []

            def observe(self, name, value):
                self.points.append((name, value))

            def observe_counters(self, vec):
                self.counters.append(vec)

        hub = Hub()
        eng = _port_engine(world, collect_metrics=True)
        srv = qt.MicroBatchServer(eng, qt.ServeConfig(max_wait_ms=1.0),
                                  hub=hub)
        try:
            srv.submit(3).result(timeout=10)
        finally:
            srv.close()
        assert [n for n, _ in hub.points] == [
            "serve_batch_fill", "serve_batch_ms", "serve_shed_level"]
        assert len(hub.counters) == 1 and hub.counters[0].shape == (25,)
        assert srv.snapshot()["counters"]["frontier_valid"] > 0
