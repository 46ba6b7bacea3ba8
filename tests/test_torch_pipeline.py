"""The port's staging ``Pipeline`` and ``pipelined`` (``pipeline.py``),
its ``faults`` and ``tracing`` copies, and ``StepStats.watch_pipeline``,
beside the JAX package's.

Every behaviour test runs on both packages' pipelines (``pkg`` is
``port`` or ``jax``) and asserts the same outcome: results in
submission order from one worker thread, backpressure at ``depth``, a
failing stage surfacing through ``Future.result()`` and ``map`` with the
rest cancelled, ``close()`` idempotent and cancelling queued work, the
``weakref.finalize`` safety net, ``try_submit`` shedding at depth, the
watchdog restart after an injected ``"pipeline.worker"`` fault with
every queued future intact, and the same ``stats()``. The tracing
spans, the fault plans' spec strings and the step-stats snapshot with a
watched pipeline are compared with JAX's directly."""

import errno
import gc
import json
import threading
import time

import numpy as np
import pytest

from quiver_tpu import faults as jfaults
from quiver_tpu import metrics as jmetrics
from quiver_tpu import pipeline as jpipeline
from quiver_tpu import tracing as jtracing
from quiver_tpu_torch import faults, metrics, pipeline, tracing

PKGS = {"port": (pipeline, faults, tracing),
        "jax": (jpipeline, jfaults, jtracing)}


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PKGS[request.param]


def _join_all(prefix, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate() if t.name == prefix]:
            return True
        time.sleep(0.01)
    return False


def test_map_and_submit_keep_order(pkg):
    pl = pkg[0]
    with pl.Pipeline(depth=2) as p:
        assert list(p.map(lambda x: x * x + 1, range(23))) == \
            [x * x + 1 for x in range(23)]
    p = pl.Pipeline(depth=3)
    futs = [p.submit(lambda x: x + 100, i) for i in range(7)]
    assert [f.result(timeout=10) for f in futs] == list(range(100, 107))
    p.close()


def test_one_worker_off_the_calling_thread(pkg):
    main = threading.get_ident()
    seen = []

    def stage(x):
        seen.append(threading.get_ident())
        time.sleep(0.005)
        return x

    with pkg[0].Pipeline(depth=2) as p:
        assert list(p.map(stage, range(6))) == list(range(6))
    assert main not in seen and len(set(seen)) == 1


def test_submit_blocks_at_depth(pkg):
    gate = threading.Event()
    p = pkg[0].Pipeline(depth=2, name="bp-pipe")
    p.submit(gate.wait)                    # the worker holds this one
    p.submit(lambda: 1)
    p.submit(lambda: 2)                    # queue now at depth 2
    blocked = threading.Event()

    def late():
        p.submit(lambda: 3)
        blocked.set()

    t = threading.Thread(target=late)
    t.start()
    assert not blocked.wait(0.2)          # backpressure: still blocked
    gate.set()
    assert blocked.wait(10)
    t.join(timeout=10)
    assert not t.is_alive()
    assert p.stats()["max_depth"] == 2
    p.close()


def test_failure_surfaces_and_cancels(pkg):
    calls = []

    def stage(x):
        calls.append(x)
        if x == 3:
            raise RuntimeError("stage blew up")
        return x

    p = pkg[0].Pipeline(depth=2)
    got = []
    with pytest.raises(RuntimeError, match="stage blew up"):
        for r in p.map(stage, range(10)):
            got.append(r)
    assert got == [0, 1, 2] and max(calls) <= 5
    f = p.submit(stage, 3)
    with pytest.raises(RuntimeError, match="stage blew up"):
        f.result(timeout=10)
    assert isinstance(f.exception(), RuntimeError)
    assert p.submit(lambda: 7).result(timeout=10) == 7
    p.close()
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(lambda: 1)
    assert p.closed


def test_close_cancels_queued_work(pkg):
    gate = threading.Event()
    p = pkg[0].Pipeline(depth=4, name="cancel-pipe")
    running = p.submit(gate.wait)
    queued = [p.submit(lambda: 1) for _ in range(3)]
    time.sleep(0.05)
    closer = threading.Thread(target=p.close)
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert running.result(timeout=10) is True
    assert all(f.cancelled() for f in queued)
    assert p.stats()["cancelled"] == 3
    assert _join_all("cancel-pipe")


def test_close_from_the_worker(pkg):
    p = pkg[0].Pipeline(depth=2, name="self-close")
    assert p.submit(p.close).result(timeout=10) is None
    assert p.closed and _join_all("self-close")


def test_finalizer_stops_a_dropped_pipeline(pkg):
    p = pkg[0].Pipeline(depth=2, name="gc-pipe")
    assert p.submit(lambda: 5).result(timeout=10) == 5
    del p
    gc.collect()
    assert _join_all("gc-pipe")


def test_pipelined_closes_on_error(pkg):
    def stage(x):
        if x == 2:
            raise ValueError("bad item")
        return x

    with pytest.raises(ValueError, match="bad item"):
        list(pkg[0].pipelined(stage, range(5), name="pipelined-err"))
    assert _join_all("pipelined-err")
    assert list(pkg[0].pipelined(lambda x: -x, range(4))) == [0, -1, -2, -3]


def test_try_submit_sheds_at_depth(pkg):
    gate = threading.Event()
    p = pkg[0].Pipeline(depth=1)
    p.submit(gate.wait)
    time.sleep(0.05)                       # the worker took it
    assert p.try_submit(lambda: 1) is not None
    assert p.try_submit(lambda: 2) is None
    gate.set()
    s = p.stats()
    assert s["dropped"] == 1 and s["submitted"] == 2
    p.close()


def test_injected_worker_death_restarts(pkg):
    """``pipeline.worker`` kills the worker before it claims an item; the
    next ``submit`` (or ``ensure_worker``) restarts it, and the queued
    futures complete."""
    pl, fl, _ = pkg
    p = pl.Pipeline(depth=4, name="chaos-pipe")
    plan = fl.install(fl.FaultPlan(rules={
        "pipeline.worker": fl.FaultRule("error", exc="runtime", times=1)}))
    try:
        f1 = p.submit(lambda: 41)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            t = p._box["thread"]
            if t is None or not t.is_alive():
                break
            time.sleep(0.01)
        assert p.ensure_worker()
        f2 = p.submit(lambda: 42)
        assert (f1.result(timeout=10), f2.result(timeout=10)) == (41, 42)
    finally:
        fl.disarm()
    s = p.stats()
    assert s["worker_restarts"] == 1 and s["completed"] == 2
    assert plan.counts()["pipeline.worker"]["fires"] == 1
    p.close()
    assert not p.ensure_worker()
    assert _join_all("chaos-pipe")


def test_stats_equal_jax():
    out = []
    for pl in (pipeline, jpipeline):
        p = pl.Pipeline(depth=3)
        futs = [p.submit(lambda x: x, i) for i in range(5)]
        futs.append(p.submit(lambda: 1 / 0))
        for f in futs:
            f.exception(timeout=10)
        s = p.stats()
        p.close()
        out.append({k: v for k, v in s.items() if "wait" not in k})
    assert out[0] == out[1]
    assert out[0]["completed"] == 5 and out[0]["failed"] == 1
    assert set(pipeline.Pipeline().stats()) == set(jpipeline.Pipeline()
                                                   .stats())


def test_future_type():
    class Tagged(pipeline.Future):
        pass

    p = pipeline.Pipeline(depth=2, future_type=Tagged)
    f = p.submit(lambda: 3)
    assert isinstance(f, Tagged) and f.result(timeout=10) == 3
    assert isinstance(p.try_submit(lambda: 4), Tagged)
    p.close()


def test_spans_match_jax(tmp_path):
    for tr, pl in ((tracing, pipeline), (jtracing, jpipeline)):
        tr.clear()
        tr.enable()
        try:
            with pl.Pipeline(depth=2, name="traced") as p:
                p.submit(lambda: 1).result(timeout=10)
                p.submit(lambda: 1 / 0).exception(timeout=10)
        finally:
            tr.disable()
    spans = [[(r[0], r[5]) for r in tr.records()]
             for tr in (tracing, jtracing)]
    assert spans[0] == spans[1]
    assert spans[0] == [
        ("pipeline.queue_wait", {"pipeline": "traced"}),
        ("pipeline.execute", {"pipeline": "traced", "ok": True}),
        ("pipeline.queue_wait", {"pipeline": "traced"}),
        ("pipeline.execute", {"pipeline": "traced", "ok": False})]
    paths = [tmp_path / "ours.json", tmp_path / "theirs.json"]
    assert tracing.export_chrome_trace(str(paths[0])) == \
        jtracing.export_chrome_trace(str(paths[1])) == 4
    evs = [[(e["ph"], e["name"], e.get("args"))
            for e in json.load(open(p))["traceEvents"] if e["ph"] == "X"]
           for p in paths]
    assert evs[0] == evs[1]
    ctx = tracing.extract(jtracing.inject({}, trace_id=9, parent="a"))
    assert (ctx.trace_id, ctx.parent) == (9, "a")
    tracing.clear()
    jtracing.clear()


@pytest.mark.parametrize("spec", [
    "pipeline.worker:error,exc=runtime,times=1",
    "io.read:error,errno=EAGAIN,rate=0.25,times=3;sink.write:delay,"
    "delay_ms=2.0",
    "rpc.request:kill,after=40;serve.execute:hang,hang_s=1.5"])
def test_fault_specs_equal_jax(spec):
    ours, theirs = faults.parse_spec(spec, seed=7), \
        jfaults.parse_spec(spec, seed=7)
    assert ours.spec() == theirs.spec() and ours.env() == theirs.env()
    env = {"QT_FAULTS": spec, "QT_FAULTS_SEED": "3"}
    assert faults.plan_from_env(env).spec() == \
        jfaults.plan_from_env(env).spec()
    assert faults.SITES == jfaults.SITES


def test_fault_rates_fire_as_jax():
    """The seeded per-site stream fires on the same visits."""
    fired = []
    for fl in (faults, jfaults):
        plan = fl.install(fl.FaultPlan(seed=11, rules={
            "sink.write": fl.FaultRule("error", rate=0.3)}))
        hits = []
        try:
            for i in range(200):
                try:
                    fl.fire("sink.write")
                except OSError as e:
                    assert e.errno == errno.EIO
                    hits.append(i)
            assert fl.drain_injected() == len(hits)
            assert fl.drain_injected() == 0
        finally:
            fl.disarm()
        assert fl.active() is None and plan.injected == len(hits)
        fired.append(hits)
    assert fired[0] == fired[1] and 30 < len(fired[0]) < 90
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan(rules={"nope": faults.FaultRule()})
    with pytest.raises(ValueError, match="unknown QT_FAULTS key"):
        faults.parse_spec("io.read:error,bogus=1")


def test_watch_pipeline_snapshot_equals_jax():
    snaps = []
    for m, pl in ((metrics, pipeline), (jmetrics, jpipeline)):
        stats = m.StepStats()
        for dt in (0.001, 0.002, 0.004):
            stats.record_step(dt)
        ps = [pl.Pipeline(depth=2), pl.Pipeline(depth=3)]
        for i, p in enumerate(ps):
            stats.watch_pipeline(p)
            for j in range(i + 2):
                p.submit(lambda: 0).result(timeout=10)
        snap = stats.snapshot()
        snaps.append((snap, stats.report()))
        for p in ps:
            p.close()
    (ours, ours_txt), (theirs, theirs_txt) = snaps
    q, jq = ours.pop("queue"), theirs.pop("queue")
    assert ours == theirs
    assert set(q) == set(jq)
    for k in q:
        if "wait" not in k:
            assert q[k] == jq[k], k
    assert q["completed"] == 5 and q["submitted"] == 5
    assert [ln.split(":")[0] for ln in ours_txt.splitlines()] == \
        [ln.split(":")[0] for ln in theirs_txt.splitlines()]
    assert ours_txt.splitlines()[-1].startswith("pipeline: cancelled=0")


def test_report_has_the_tracer_line():
    tracing.disable()
    text = metrics.report()
    line = [ln for ln in text.splitlines() if ln.startswith("tracing:")]
    tr = tracing.get_tracer()
    assert line == [f"tracing: off ({len(tr)}/{tr.capacity} spans "
                    "retained)"]


def test_sink_write_fault_is_counted(tmp_path):
    sink = metrics.MetricsSink(str(tmp_path / "s.jsonl"))
    faults.install(faults.FaultPlan(rules={
        "sink.write": faults.FaultRule("error", times=2)}))
    try:
        for i in range(4):
            sink.emit({"i": i}, kind="x")
    finally:
        faults.disarm()
    sink.close()
    assert sink.write_errors == 2
    recs = metrics.read_jsonl(str(tmp_path / "s.jsonl"))
    assert [r["i"] for r in recs if r["kind"] == "x"] == [2, 3]
    assert np.isfinite(recs[-1]["ts"])
