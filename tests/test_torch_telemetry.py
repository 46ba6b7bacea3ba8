"""The port's telemetry hub (``quiver_tpu_torch/telemetry.py``) against
the JAX package's (``quiver_tpu/telemetry.py``), adapted from
``tests/test_telemetry.py``:

- ``SeriesRing`` stats and the three detectors' firings equal on the same
  series;
- one hub driven through both packages with the same counter vectors
  (the port's as torch tensors, JAX's as numpy), host series and a
  ``PlanContext``: the same series, counter totals, anomaly records,
  snapshot and advice; ``rows_for_hit_rate`` equal;
- advice from the same ingested JSONL (cumulative counters of two hosts,
  ``serving``, ``slo`` and ``tenant`` records, re-read as the files
  grow) equal, timestamps aside;
- ``observe_counters`` never converts the newest vector to a host array
  before the next observation (a counter object that counts its
  conversions), and ``flush`` folds it;
- ``watch_compiles`` over the loaded kernel libraries, the
  process-default ``hub()``, and the ``FlightRecorder``'s dump."""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from quiver_tpu import metrics as jmetrics
from quiver_tpu import telemetry as jtel
from quiver_tpu_torch import metrics as qm
from quiver_tpu_torch import telemetry as tel
from quiver_tpu_torch import tracing


def vec(lib=np, **named):
    v = np.zeros((qm.NUM_COUNTERS,), np.int32)
    for slot, name in qm.SLOT_NAMES.items():
        if name in named:
            v[slot] = named.pop(name)
    assert not named, named
    return torch.from_numpy(v) if lib is torch else v


def series(seed, n=120):
    rng = np.random.default_rng(seed)
    base = np.concatenate([np.full(n // 2, 0.8), np.full(n - n // 2, 0.3)])
    return (base + 0.05 * rng.standard_normal(n)).tolist()


@pytest.mark.parametrize("cap", [2, 7, 64, 500])
def test_series_ring_equals_jaxs(cap):
    got, want = tel.SeriesRing(cap), jtel.SeriesRing(cap)
    for x in series(cap):
        got.append(x)
        want.append(x)
        assert got.last() == want.last()
    np.testing.assert_array_equal(got.values(), want.values())
    assert (len(got), got.total, got.wrapped) == \
        (len(want), want.total, want.wrapped)
    for w in (1, 4, 16, 1000):
        assert got.window_stats(w) == want.window_stats(w)
    for a in (0.1, 0.3, 0.9):
        assert got.ewma(a) == want.ewma(a)
    assert tel.SeriesRing(2).window_stats() is None


@pytest.mark.parametrize("kind,kw", [
    ("mean_shift", {}), ("mean_shift", {"direction": "down", "window": 4}),
    ("mean_shift", {"direction": "up", "threshold": 0.1}),
    ("page_hinkley", {}), ("page_hinkley", {"delta": 0.05,
                                            "threshold": 1.0}),
    ("page_hinkley", {"direction": "up"}), ("spike", {"threshold": 0.5}),
    ("spike", {"threshold": 0.6, "direction": "down"}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_detector_firings_equal_jaxs(kind, kw, seed):
    got = tel._DETECTOR_TYPES[kind](**kw)
    want = jtel._DETECTOR_TYPES[kind](**kw)
    fired = []
    for x in series(seed) + series(seed + 7)[::-1]:
        a, b = got.update(x), want.update(x)
        assert a == b
        fired.append(a is not None)
    assert any(fired)


def test_names_and_errors_equal_jaxs():
    assert tel.DETECTOR_NAMES == jtel.DETECTOR_NAMES
    assert tel.ADVICE_KEYS == jtel.ADVICE_KEYS
    assert tel.DEFAULT_WATCHES == jtel.DEFAULT_WATCHES
    for make in (lambda m: m.SeriesRing(1),
                 lambda m: m.MeanShiftDetector(direction="x"),
                 lambda m: m.PageHinkleyDetector(direction="x"),
                 lambda m: m.SpikeDetector(direction="both"),
                 lambda m: m.TelemetryHub().watch("x", "nope")):
        with pytest.raises(ValueError) as got:
            make(tel)
        with pytest.raises(ValueError) as want:
            make(jtel)
        assert str(got.value) == str(want.value)


PLANS = [
    dict(hot_capacity=100, total_rows=1000, expected_hit_rate=0.9,
         degree=np.arange(1000, 0, -1), exchange_cap=512,
         dedup_budget=256, batch_cap=32, max_wait_ms=2.0,
         target_p99_ms=50.0),
    dict(hot_capacity=100, expected_hit_rate=0.8, exchange_cap=64,
         batch_cap=256, max_wait_ms=1.0, target_p99_ms=100.0,
         io_workers=2, io_qd=8, partitions=1, locality_weight=0.5,
         degree=np.ones(500)),
    dict(exchange_cap=512, dedup_budget=600, locality_weight=0.75),
]


def drive(pkg, lib, plan, steps=40):
    """One hub through ``steps`` metered steps whose hot tier collapses
    half way, plus host series; returns what the test compares."""
    sink = ListSink()
    hub = pkg.TelemetryHub(capacity=64, window=4, fold_every=3, sink=sink,
                           plan=pkg.PlanContext(**plan))
    rng = np.random.default_rng(0)
    for i in range(steps):
        hot = 90 if i < steps // 2 else 20
        v = vec(lib, hot_rows=hot + int(rng.integers(0, 5)), cold_rows=10,
                lookup_calls=1, exchange_calls=1,
                exchange_fallback=int(i % 9 == 0),
                exchange_bucket_max=int(rng.integers(30, 450)),
                exchange_cap=512, dedup_calls=1, dedup_total=900,
                dedup_unique=int(rng.integers(200, 700)),
                dedup_overflow=int(i % 5 == 0), frontier_valid=700,
                frontier_cap=1024, prefetch_hit_rows=int(rng.integers(0, 9)),
                prefetch_sync_rows=3, locality_hit_rows=5,
                locality_miss_rows=int(rng.integers(0, 9)))
        if i % 2:
            hub.observe_step(0.001 * (i + 1), v)
        else:
            hub.observe_counters(v)
        hub.observe("serve_batch_fill", float(rng.integers(1, 40)))
        hub.observe("serve_request_p99_ms", 20.0 + i)
        hub.observe("cold_staged_rows_per_s", 1000.0)
        hub.observe("stage_share:serve/gather", 0.1 if i < 30 else 0.6)
        hub.observe("nan", float("nan"))
    hub.watch("hot_*", "spike", threshold=0.99)
    hub.observe("hot_other", 1.5)
    advice = hub.replan()
    snap = hub.snapshot()
    return {"snapshot": snap, "advice": advice,
            "series": {k: s.values().tolist() for k, s in hub.series.items()},
            "counters": hub.counters().tolist(), "sink": sink.records,
            "report": hub.report()}


class ListSink:
    def __init__(self):
        self.records = []

    def emit(self, rec, kind=None):
        self.records.append(dict(rec, kind=kind))
        return rec


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_hub_equals_jaxs(plan):
    got = drive(tel, torch, PLANS[plan])
    want = drive(jtel, np, PLANS[plan])
    for key in ("snapshot", "advice", "series", "counters", "sink",
                "report"):
        assert got[key] == want[key], key
    assert any(r["kind"] == "anomaly" for r in got["sink"])
    assert got["advice"] or plan == 2


@pytest.mark.parametrize("deg,target", [
    ([4.0, 3.0, 2.0, 1.0], 0.4), ([4.0, 3.0, 2.0, 1.0], 1.0),
    ([0.0, 0.0], 0.5), (list(range(100)), 0.77), ([5.0], -1.0)])
def test_rows_for_hit_rate_equals_jaxs(deg, target):
    assert tel.rows_for_hit_rate(deg, target) == \
        jtel.rows_for_hit_rate(deg, target)


def _write_host(pkg_metrics, path, host, upto):
    with pkg_metrics.MetricsSink(path, max_bytes=4096) as sink:
        for i in range(upto):
            c = {"hot_rows": 50 * (i + 1) * host,
                 "cold_rows": (30 + 5 * i) * (i + 1),
                 "exchange_bucket_max": 100 + 10 * i, "exchange_cap": 256,
                 "exchange_calls": i + 1, "dedup_calls": i + 1,
                 "dedup_unique": 400 * (i + 1), "dedup_total": 900 * (i + 1)}
            sink.emit({"counters": c, "wall": {"p50_ms": 1.0 + i}},
                      kind="step_stats")
            sink.emit({"counters": c, "request": {"p99_ms": 60.0 + i},
                       "serving": {"queue_depth": i, "shed_level": i % 2,
                                   "mean_batch_fill": 30.0}},
                      kind="serving")
            sink.emit({"windows": {"short": {"burn_rate": 0.5 * i},
                                   "long": {"burn_rate": 0.1}},
                       "budget_remaining": 1.0 - 0.01 * i}, kind="slo")
            sink.emit({"tenant": "interactive",
                       "latency": {"p99_ms": 10.0 + i}, "shed": i,
                       "slo": {"windows": {"short": {"burn_rate": 2.0}}}},
                      kind="tenant")


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def test_ingested_advice_equals_jaxs(tmp_path):
    paths = [str(tmp_path / f"h{i}.jsonl") for i in range(2)]
    plan = dict(exchange_cap=512, dedup_budget=256, batch_cap=32,
                max_wait_ms=2.0, target_p99_ms=50.0)
    hubs = {}
    for name, pkg in (("port", tel), ("jax", jtel)):
        out = tmp_path / f"advice_{name}.jsonl"
        sink = (qm if pkg is tel else jmetrics).MetricsSink(str(out))
        hubs[name] = (pkg.TelemetryHub(window=4, sink=sink,
                                       plan=pkg.PlanContext(**plan)),
                      sink, out)
    counts = {}
    for upto in (5, 12, 30):                 # the files grow (and roll)
        for h, p in enumerate(paths):
            _write_host(qm, p, h + 1, upto)
        for name, (hub, _, _) in hubs.items():
            counts.setdefault(name, []).append(
                [hub.ingest_jsonl(p) for p in paths])
    assert counts["port"] == counts["jax"]
    for name, (hub, sink, _) in hubs.items():
        hub.replan()
        sink.close()
    got = _strip(qm.read_jsonl(str(hubs["port"][2])))
    want = _strip(qm.read_jsonl(str(hubs["jax"][2])))
    assert [r for r in got if r["kind"] != "meta"] == \
        [r for r in want if r["kind"] != "meta"]
    assert any(r["kind"] == "advice" for r in got)
    assert hubs["port"][0].snapshot() == hubs["jax"][0].snapshot()


class Counted:
    """A counter vector that counts its host conversions."""

    def __init__(self, v):
        self.v = v
        self.converted = 0

    def __array__(self, dtype=None, copy=None):
        self.converted += 1
        return np.asarray(self.v, dtype=dtype)


@pytest.mark.parametrize("fold_every", [1, 2, 5])
@pytest.mark.parametrize("through", ["counters", "step"])
def test_newest_vector_never_converted(fold_every, through):
    hub = tel.TelemetryHub(fold_every=fold_every, watches=())
    spies = [Counted(vec(hot_rows=i + 1, cold_rows=1)) for i in range(12)]
    for s in spies:
        if through == "counters":
            hub.observe_counters(s)
        else:
            hub.observe_step(0.001, s)
        assert s.converted == 0
    assert any(s.converted for s in spies[:-1])
    hub.flush()
    assert all(s.converted == 1 for s in spies)
    assert hub.counters()[qm.HOT_ROWS] == sum(range(1, 13))


def test_counters_equal_reduce_counters():
    """After ``flush`` the totals are ``metrics.reduce_counters`` of the
    same vectors (stacked ``[shards, N]`` ones included)."""
    vecs = [vec(torch, hot_rows=i, cold_rows=2 * i, exchange_bucket_max=i,
                exchange_cap=9) for i in range(10)]
    vecs.append(torch.stack([vecs[1], vecs[7]]))
    hub = tel.TelemetryHub(fold_every=4, watches=())
    for v in vecs:
        hub.observe_counters(v)
    hub.flush()
    want = qm.reduce_counters(torch.cat([v.reshape(-1, qm.NUM_COUNTERS)
                                         for v in vecs]))
    np.testing.assert_array_equal(hub.counters(), want)


def test_watch_compiles_loaded_libraries():
    from quiver_tpu_torch.ops.kernels import _build

    class Fn:
        n = 1

        def _cache_size(self):
            return self.n

    fn = Fn()
    hub = tel.TelemetryHub(fold_every=1)
    hub.watch_compiles(fn, _build.loaded_libraries, object())
    hub.observe_counters(vec(hot_rows=1))
    hub.flush()
    assert hub.series["recompiles"].values().tolist() == [0.0]
    fn.n += 1
    hub.observe_counters(vec(hot_rows=1))
    hub.flush()
    assert hub.series["recompiles"].last() == 1.0
    assert any(a["series"] == "recompiles" for a in hub.anomalies)
    assert _build.loaded_libraries._cache_size() == len(_build._loaded)


def test_default_hub_installs_report():
    h = tel.hub()
    assert tel.hub() is h
    assert "telemetry hub" in qm.report()


def test_flight_recorder_dump(tmp_path):
    hub = tel.TelemetryHub(watches=())
    hub.observe("hot_hit_rate", 0.5)
    hub.observe_counters(vec(torch, hot_rows=10, cold_rows=10))
    hub.advice["hot_capacity"] = {"key": "hot_capacity", "current": 1,
                                  "recommended": 2, "reason": "r"}
    prev = tracing.get_tracer().capacity
    tracing.enable(capacity=64)
    try:
        tracing.record("test.span", 0.0, 0.5, None, {"k": 1})
        fr = tel.FlightRecorder(path=str(tmp_path / "pm.json"), hub=hub)
        doc = json.load(open(fr.dump(reason="unit-test")))
    finally:
        tracing.enable(capacity=prev)
        tracing.disable()
        tracing.clear()
    assert doc["reason"] == "unit-test"
    assert any(s["name"] == "test.span" for s in doc["spans"])
    assert doc["series"]["hot_hit_rate"] == [0.5, 0.5]
    assert doc["counters"]["hot_rows"] == 10
    assert doc["advice"]["hot_capacity"]["recommended"] == 2
    calls = []
    old = signal.signal(signal.SIGUSR1, lambda s, f: calls.append(s))
    fr = tel.FlightRecorder(path=str(tmp_path / "sig.json"), hub=hub)
    try:
        fr.install(signals=(signal.SIGUSR1,), excepthook=False)
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not calls and time.time() < deadline:
            time.sleep(0.01)
        assert calls == [signal.SIGUSR1]
        assert "SIGUSR1" in json.load(open(tmp_path / "sig.json"))["reason"]
    finally:
        fr.uninstall()
        signal.signal(signal.SIGUSR1, old)
