"""The port's fleet plane (``quiver_tpu_torch/fleet.py``) against the JAX
package's (``quiver_tpu/fleet.py``), adapted from ``tests/test_fleet.py``:

- ``FleetAggregator`` over the same replica sink files (three writer
  processes: one healthy with an SLO burn, one across a rollover seam
  shedding a step, one that goes silent) under one fake clock: the same
  snapshots, staleness anomalies, ``fleet`` records (timestamps aside),
  per-replica and fleet counters, and Prometheus text;
- ``FleetExporter`` over HTTP: ``/metrics`` is ``prometheus_text``,
  ``/healthz`` answers 200 and then 503 when every replica is stale,
  other paths 404, a scrape polls a stopped aggregator;
- ``HealthRouter``: the same pick and rank sequences for one seed and
  one script of scores, drains, re-admits and locality blends;
  ``plan_quality`` equal;
- ``ReplicaSupervisor`` under a fake clock and fake processes: the same
  backoff, breaker, grow, shrink and kill schedules and events.

Every test that spawns a process or opens a socket runs under a time
limit (``SIGALRM``)."""

import json
import os
import random
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import quiver_tpu.fleet as jf
from quiver_tpu import metrics as jm
from quiver_tpu_torch import fleet as qf
from quiver_tpu_torch import metrics as qm
from quiver_tpu_torch import serving

LIMIT_S = 30


@pytest.fixture
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# stdlib emitters: each writes its own sink, meta header first, as a
# MetricsSink would (tests/test_fleet.py's)
_EMITTER = r"""
import json, os, sys
path, mode = sys.argv[1], sys.argv[2]

def w(f, rec):
    f.write(json.dumps(rec) + "\n")

def meta(f, replica):
    w(f, {"ts": 0.0, "kind": "meta", "host": "test-host",
          "pid": os.getpid(), "start_ts": 0.0, "replica": replica})

def step(hot, cold, peak):
    return {"ts": 0.0, "kind": "step_stats",
            "counters": {"hot_rows": hot, "cold_rows": cold,
                         "exchange_bucket_max": peak},
            "wall": {"p50_ms": 2.0}}

if mode == "plain":
    with open(path, "w") as f:
        meta(f, "r0")
        w(f, step(10, 5, 3))
        w(f, step(20, 10, 4))
        w(f, step(30, 15, 4))
        w(f, {"ts": 0.0, "kind": "slo",
              "windows": {"short": {"burn_rate": 1.5},
                          "long": {"burn_rate": 1.25}},
              "budget_remaining": 0.2})
        w(f, {"ts": 0.0, "kind": "tenant", "tenant": "interactive",
              "priority": 2, "requests": 9, "completed": 8, "rejected": 1,
              "shed": 1, "latency": {"p99_ms": 12.5},
              "slo": {"windows": {"short": {"burn_rate": 0.5}}}})
        w(f, {"ts": 0.0, "kind": "trace", "trace_id": 77,
              "root": "serve.request", "replica": "r0", "policy": "error",
              "duration_ms": 12.0, "spans": []})
elif mode == "seam":
    with open(path + ".1", "w") as f:
        meta(f, "r1")
        w(f, step(40, 20, 9))
    with open(path, "w") as f:
        meta(f, "r1")
        w(f, step(100, 50, 9))
        w(f, {"ts": 0.0, "kind": "serving",
              "counters": {"hot_rows": 1},
              "request": {"p99_ms": 30.0},
              "serving": {"queue_depth": 2, "shed_level": 1,
                          "mean_batch_fill": 4.0, "partition": 1,
                          "fanout_variants": [[4, 4], [2, 2], [1, 1]]},
              "derived": {"locality_hit_rate": 0.75}})
elif mode == "silent":
    with open(path, "w") as f:
        meta(f, "r2")
        w(f, step(7, 3, 1))
"""


def _emitters(tmp_path):
    paths = {n: str(tmp_path / f"{n}.jsonl") for n in ("r0", "r1", "r2")}
    procs = [subprocess.Popen([sys.executable, "-c", _EMITTER, paths[n], m])
             for n, m in (("r0", "plain"), ("r1", "seam"),
                          ("r2", "silent"))]
    for p in procs:
        assert p.wait(timeout=20) == 0
    return paths


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs
            if r.get("kind") != "meta"]


def test_health_score_is_servings():
    assert qf.health_score is serving.health_score
    for kw in (dict(), dict(burn=1.5, shed_frac=0.5),
               dict(burn=4.0, shed_frac=2.0), dict(stale=True, age_s=3.0)):
        assert qf.health_score(**kw) == jf.health_score(**kw)


def test_aggregator_equals_jaxs(tmp_path, time_limit):
    paths = _emitters(tmp_path)
    fake = [0.0]
    out = {}
    for name, mod, met in (("port", qf, qm), ("jax", jf, jm)):
        sink_path = str(tmp_path / f"fleet_{name}.jsonl")
        sink = met.MetricsSink(sink_path)
        agg = mod.FleetAggregator(paths, interval_s=1.0, stale_after_s=3.0,
                                  sink=sink, clock=lambda: fake[0])
        out[name] = dict(agg=agg, sink=sink, path=sink_path, snaps=[])
    for t, append in ((0.0, False), (3.5, True), (4.0, False)):
        fake[0] = t
        if append:
            with open(paths["r0"], "a") as f:
                f.write(json.dumps(
                    {"ts": 0.0, "kind": "step_stats",
                     "counters": {"hot_rows": 35, "cold_rows": 15,
                                  "exchange_bucket_max": 4}}) + "\n")
        for o in out.values():
            o["snaps"].append(o["agg"].poll())
            o["text"] = (o["agg"].snapshot(),
                         (qf if o is out["port"] else jf).prometheus_text(
                             o["agg"]))
    got, want = out["port"], out["jax"]
    assert got["snaps"] == want["snaps"]
    assert got["text"] == want["text"]
    assert list(got["agg"].anomalies) == list(want["agg"].anomalies)
    assert [a["replica"] for a in got["agg"].anomalies] == ["r1", "r2"]
    for n in ("r0", "r1", "r2"):
        assert got["agg"].replica_hub(n).snapshot() == \
            want["agg"].replica_hub(n).snapshot()
    assert got["agg"].fleet.counters().tolist() == \
        want["agg"].fleet.counters().tolist()
    assert got["agg"].fleet.counters()[qm.HOT_ROWS] == 35 + 101 + 7
    assert got["agg"].traces.get(77) == want["agg"].traces.get(77)
    assert got["snaps"][-1]["replicas"]["r1"]["partition"] == 1
    assert 'trace_id="77"' in got["text"][1]
    for o in out.values():
        o["agg"].close()
        o["sink"].close()
    assert _strip(qm.read_jsonl(got["path"])) == \
        _strip(qm.read_jsonl(want["path"]))


def test_aggregator_checks_and_thread(tmp_path, time_limit):
    p = str(tmp_path / "a.jsonl")
    open(p, "w").write(json.dumps(
        {"kind": "step_stats", "counters": {"hot_rows": 1}}) + "\n")
    for bad in ({}, []):
        with pytest.raises(ValueError):
            qf.FleetAggregator(bad)
    agg = qf.FleetAggregator([p], interval_s=0.05)
    assert agg.replica_names == ["r0"]
    agg.start()
    import time
    deadline = time.monotonic() + 10.0
    while agg.polls == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert agg.polls > 0 and agg.running
    agg.close()
    agg.close()
    assert not agg.running
    with pytest.raises(RuntimeError):
        agg.start()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10)


def test_exporter_over_http(tmp_path, time_limit):
    paths = _emitters(tmp_path)
    fake = [0.0]
    agg = qf.FleetAggregator(paths, interval_s=1.0, stale_after_s=3.0,
                             clock=lambda: fake[0])
    exp = qf.FleetExporter(agg, port=0)
    try:
        before = agg.polls
        with _get(exp.port, "/metrics") as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
        assert agg.polls == before + 1
        assert body == qf.prometheus_text(agg)
        assert ctype.startswith("application/openmetrics-text")
        for needle in ('qt_replica_health{replica="r0"} 0.75',
                       "qt_fleet_replicas 3",
                       'qt_counter_total{name="hot_rows"} 138',
                       'qt_tenant_p99_ms{replica="r0",tenant="interactive"}'
                       ' 12.5', "# EOF"):
            assert needle in body, needle
        with _get(exp.port, "/healthz") as h:
            assert h.status == 200
            assert json.loads(h.read())["fleet"]["status"] == "ok"
        fake[0] = 10.0
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(exp.port, "/healthz")
        assert e.value.code == 503
        assert json.loads(e.value.read())["fleet"]["status"] == "down"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(exp.port, "/nope")
        assert e.value.code == 404
    finally:
        exp.close()
        agg.close()
    idle = qf.FleetExporter(agg, port=0, start=False)
    idle.close()


def _route(mod, seed):
    """One seeded script of router calls; everything it returns."""
    rng = random.Random(seed)
    names = ["a", "b", "c", "d"]
    r = mod.HealthRouter(names, seed=seed, drain_below=0.25,
                         readmit_above=0.5)
    out = []
    table = np.random.default_rng(seed).random((20, 3)).astype(np.float32)
    for step in range(300):
        op = rng.random()
        if op < 0.15:
            r.update(rng.choice(names + ["e"]), rng.random())
        elif op < 0.18:
            r.drain(rng.choice(names))
        elif op < 0.21:
            r.readmit(rng.choice(names))
        elif op < 0.23:
            r.set_locality(table, {"a": 0, "b": 1, "c": 2},
                           weight=rng.choice([0.0, 0.5, 0.8]))
        elif op < 0.24:
            r.forget(rng.choice(names))
        elif op < 0.26:
            r.sync({"replicas": {n: {"health": rng.random()}
                                 for n in names[:2]}})
        elif op < 0.6:
            seed_id = rng.choice([None, rng.randrange(25)])
            out.append(("pick", r.pick(exclude=rng.sample(names, 1),
                                       seed=seed_id)))
        else:
            seed_id = rng.choice([None, rng.randrange(25)])
            out.append(("ranked", r.ranked(exclude=rng.sample(names, 2),
                                           seed=seed_id)))
    out.append(("snapshot", r.snapshot()))
    return out


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_router_sequences_equal_jaxs(seed):
    assert _route(qf, seed) == _route(jf, seed)


def test_router_checks_and_plan_quality():
    for kw in (dict(drain_below=0.8, readmit_above=0.5),):
        with pytest.raises(ValueError):
            qf.HealthRouter(**kw)
    r = qf.HealthRouter(["a"])
    with pytest.raises(ValueError, match="weight"):
        r.set_locality(np.eye(2), {}, weight=1.0)
    with pytest.raises(ValueError, match="table"):
        r.set_locality(np.zeros(3), {}, weight=0.5)
    with pytest.raises(ValueError):
        qf.HealthRouter().pick()
    snaps = [
        {"replicas": {}},
        {"replicas": {"a": {"components": {"burn": 2.6}},
                      "b": {"components": {"burn": 1.9}},
                      "c": {"stale": True, "components": {"burn": 9}}}},
        {"replicas": {"a": {"components": {"burn": 0.5}}}},
        {"replicas": {"a": {"components": {"stale": True}}}},
    ]
    for snap in snaps:
        for ladder in (0, 1, 3):
            for step_burn in (0.25, 0.5):
                assert qf.HealthRouter.plan_quality(
                    snap, ladder, step_burn) == \
                    jf.HealthRouter.plan_quality(snap, ladder, step_burn)


class _FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self._rc = None

    def poll(self):
        return self._rc

    def die(self, rc=1):
        self._rc = rc

    def terminate(self):
        if self._rc is None:
            self._rc = 0

    def kill(self):
        self._rc = -9

    def send_signal(self, sig):
        self._rc = -int(sig)

    def wait(self, timeout=None):
        return self._rc


def _supervise(mod):
    """One fake-clock script: spawns, crashes, a crash loop, a failing
    spawn, healthy uptime, grow/shrink/scale_to and kill; every event
    and status."""
    clk = [0.0]
    procs = {}
    pid = [100]
    bad = {"r2": 2}

    def spawn(name, index, attempt):
        if bad.get(name):
            bad[name] -= 1
            raise OSError("no such binary")
        pid[0] += 1
        procs.setdefault(name, []).append(_FakeProc(pid[0]))
        return procs[name][-1]

    sup = mod.ReplicaSupervisor(spawn, 3, backoff_s=0.5, backoff_cap_s=4.0,
                                crash_loop_limit=3, crash_loop_window_s=20.0,
                                breaker_reset_s=30.0, healthy_uptime_s=10.0,
                                clock=lambda: clk[0])
    trail = []
    rng = random.Random(4)
    for tick in range(160):
        clk[0] = tick * 0.5
        if tick in (5, 6, 7, 9, 11, 13, 15, 70):
            live = [p for p in procs.get("r0", []) if p.poll() is None]
            if live:
                live[-1].die(rc=-9)
        if tick == 40:
            trail.append(("grow", sup.grow(2)))
        if tick == 45:
            trail.append(("shrink", sup.shrink(1, drain=trail.append)))
        if tick == 50:
            trail.append(("scale_to", sup.scale_to(2)))
        if tick == 55:
            trail.append(("kill", sup.kill("r1")))
        if rng.random() < 0.05 and procs.get("r1"):
            procs["r1"][-1].die(rc=3)
        sup.step()
        trail.append(("status", sup.status()))
    trail.append(("count", sup.replica_count))
    with pytest.raises(ValueError):
        sup.shrink(names=list(sup.names))
    with pytest.raises(ValueError):
        sup.scale_to(0)
    sup.close()
    return list(sup.events), trail


def test_supervisor_schedules_equal_jaxs():
    got, want = _supervise(qf), _supervise(jf)
    assert got == want
    events = [e["event"] for e in got[0]]
    for e in ("spawn", "exit", "restart", "breaker_open", "breaker_reset",
              "spawn_error", "scale_up", "scale_down"):
        assert e in events, e


def test_supervisor_events_reach_the_sink(tmp_path):
    path = str(tmp_path / "chaos.jsonl")
    sink = qm.MetricsSink(path)
    sup = qf.ReplicaSupervisor(lambda n, i, a: _FakeProc(7), 1,
                               backoff_s=0.1, sink=sink, clock=lambda: 0.0)
    sup.step()
    sup.close()
    sink.close()
    recs = [r for r in qm.read_jsonl(path) if r["kind"] == "chaos"]
    assert [r["event"] for r in recs] == ["spawn"]
    assert recs[0]["replica"] == "r0" and recs[0]["pid"] == 7
    with pytest.raises(ValueError):
        qf.ReplicaSupervisor(lambda *a: None, 0)
    with pytest.raises(ValueError):
        qf.ReplicaSupervisor(lambda *a: None, 2, names=["x", "x"])
