"""The port's operator CLIs (``quiver_tpu_torch.scripts``: qt_top,
qt_trace, qt_agg, qt_capacity) against the JAX package's ``scripts/``.

Each JAX script is loaded by path and run in this process beside the
port's module on the same JSONL files, with the clock frozen
(``time.strftime`` and ``time.time``: both print the wall time in their
headers). Their text must be equal, with color on and off; qt_trace's
``--export`` JSON must parse equal; qt_capacity's appended record must
equal JAX's field for field but for ``ts``. Where the port's own
emitters can write a record kind (``MetricsSink.emit_stats``,
``SloBudget.emit``, ``TelemetryHub``, ``Actuator``,
``MicroBatchServer.emit``/``emit_tenants``, ``capacity.emit``,
``FleetAggregator``'s sink, ``TailSampler``, ``Finding.record``,
``StageProfiler``), the files are theirs. qt_top and qt_trace import
neither torch nor numpy."""

import functools
import importlib.util
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from quiver_tpu_torch import (actuator, capacity, fleet, tailsampling,
                              telemetry, tracing)
from quiver_tpu_torch import metrics as qm
from quiver_tpu_torch.analysis.findings import Finding
from quiver_tpu_torch.scripts import qt_agg, qt_capacity, qt_top, qt_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"qt_top": qt_top, "qt_trace": qt_trace, "qt_agg": qt_agg,
        "qt_capacity": qt_capacity}
FROZEN_CLOCK = "07:08:09"
FROZEN_TIME = 1_700_000_000.25


@functools.lru_cache(maxsize=None)
def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, t=None: FROZEN_CLOCK)
    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)


def run_one(mod, argv, capsys, monkeypatch, color):
    """``(rc, stdout)`` of one CLI module; ``color`` forces the escapes
    (as a terminal would) or turns them off."""
    if color:
        monkeypatch.setenv("FORCE_COLOR", "1")
        monkeypatch.setattr(sys.stdout, "isatty", lambda: True)
    else:
        monkeypatch.delenv("FORCE_COLOR", raising=False)
        argv = [*argv, "--no-color"]
    rc = mod.main(list(argv))
    return rc, capsys.readouterr().out


def run_both(name, argv, capsys, monkeypatch, color):
    """``run_one`` of the JAX script, then of the port's module, on the
    same arguments."""
    return [run_one(mod, argv, capsys, monkeypatch, color)
            for mod in (jax_script(name), PORT[name])]


def write_jsonl(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# sinks written by the port's emitters
# ---------------------------------------------------------------------------


def counter_vec(**named):
    import torch
    v = np.zeros((qm.NUM_COUNTERS,), np.int32)
    for slot, name in qm.SLOT_NAMES.items():
        if name in named:
            v[slot] = named.pop(name)
    assert not named, named
    return torch.from_numpy(v)


class FixedEngine:
    """A serve engine stand-in: each node's fixed row of 3 logits."""
    batch_cap, variants = 16, [[1]]
    collect_metrics, jitted_fns = False, ()

    def run(self, seeds, variant=0):
        s = np.asarray(seeds, np.float32)
        return np.stack([s, s * 0.5, np.mod(s, 7)], 1)


def emit_serving(sink, requests=24):
    """``serving`` and ``tenant`` records of a ``MicroBatchServer`` that
    answered ``requests`` point queries across the default classes."""
    from quiver_tpu_torch.serving import (MicroBatchServer, ServeConfig,
                                          default_tenant_classes)
    srv = MicroBatchServer(FixedEngine(),
                           ServeConfig(max_wait_ms=1.0, slo_p99_ms=50.0),
                           tenants=default_tenant_classes(50.0))
    try:
        names = ("interactive", "batch", "best_effort")
        futs = [srv.submit(i, tenant=names[i % 3]) for i in range(requests)]
        for f in futs:
            f.result(timeout=30)
        srv.emit(sink)
        srv.emit_tenants(sink)
    finally:
        srv.close()


def emit_traces(client_sink, replica_sink):
    """Kept traces of both sides of the wire: the client's ``rpc.lookup``
    segments and a replica's ``serve.request`` ones, joined by id."""
    for sink, replica, root, inner in (
            (client_sink, "client", "rpc.lookup", "rpc.attempt"),
            (replica_sink, "r0", "serve.request", "serve.dispatch")):
        tracing.set_replica(replica)
        tracer = tracing.Tracer(capacity=256)
        sampler = tailsampling.TailSampler(sink=sink, head_rate=1.0,
                                           seed=3).attach(tracer)
        try:
            for i, tid in enumerate((101, 102, 103, 104)):
                t0 = 0.01 * i
                dur = 0.002 * (i + 1) + (0.05 if tid == 103 else 0.0)
                args = {"error": "OSError"} if tid == 104 else None
                tracer.record(inner, t0 + 0.0005, dur * 0.8, tid, None)
                tracer.record(root, t0, dur, tid, args)
        finally:
            sampler.detach()
            tracing.set_replica(None)


def emit_profile(sink):
    import torch
    from quiver_tpu_torch.analysis.costmodel import cost_of_fn
    from quiver_tpu_torch.profile import (ProfileGroup, ProfileStage,
                                          StageProfiler, machine_probe)
    x = torch.arange(4096, dtype=torch.float32)
    ids = torch.arange(0, 4096, 3)
    stages = []
    for name, fn, args in (("copy", torch.clone, (x,)),
                           ("gather", torch.index_select, (x, 0, ids))):
        stages.append(ProfileStage(name, fn, args,
                                   cost=cost_of_fn(fn, args)))
    probe = machine_probe(quick=True, size_mb=1, device="cpu")
    StageProfiler(reps=2, probe=probe, sink=sink).add_group(
        ProfileGroup("serve_step", stages)).run()


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    """One sink holding every kind qt_top renders, each written by the
    port's own emitter (``regress`` has none: the port has no benchmark
    sentinel yet, so the record goes through ``MetricsSink.emit``), and
    beside it the replica and client sinks its fleet and trace records
    come from."""
    d = tmp_path_factory.mktemp("emitted")
    path, replica, client = (str(d / f"{n}.jsonl")
                             for n in ("run", "r0", "client"))
    with qm.MetricsSink(replica, replica="r0") as rsink, \
            qm.MetricsSink(client, replica="client") as csink:
        emit_serving(rsink)
        emit_traces(csink, rsink)
    sink = qm.MetricsSink(path, max_bytes=12_000, replica="run")
    try:
        stats = qm.StepStats(fold_every=1)
        for i in range(10):
            hot = 90 if i < 5 else 20
            stats.record_step(0.004 + 0.0005 * i, counter_vec(
                hot_rows=hot, cold_rows=10, lookup_calls=1))
            sink.emit_stats(stats)
        slo = qm.SloBudget(50.0, min_requests=4)
        for i in range(12):
            slo.record(0.01 * (i + 1), ok=i % 5 != 0)
            if i % 4 == 3:
                slo.emit(sink)
        hub = telemetry.TelemetryHub(
            capacity=64, window=4, fold_every=1, sink=sink,
            plan=telemetry.PlanContext(
                hot_capacity=100, total_rows=1000, expected_hit_rate=0.9,
                degree=np.arange(1000, 0, -1), batch_cap=32,
                max_wait_ms=2.0, target_p99_ms=50.0))
        for i in range(24):
            hub.observe_counters(counter_vec(
                hot_rows=90 if i < 12 else 20, cold_rows=10,
                lookup_calls=1))
        hub.replan()
        val = {"batch_cap": 8}
        clk = [0.0]
        act = actuator.Actuator(sink=sink, clock=lambda: clk[0])
        act.register(actuator.Knob(
            "batch_cap", read=lambda: val["batch_cap"],
            apply=lambda v: val.__setitem__("batch_cap", v),
            lattice=(2, 4, 8)))
        adv = {"current": None, "observed": {}, "reason": "mostly padding"}
        act.tick([dict(adv, key="batch_cap", recommended=4)])
        clk[0] = 100.0
        act.tick([dict(adv, key="batch_cap", recommended=3)])
        emit_serving(sink)
        pred = capacity.predict(batch_cap=16, dispatch_ms=4.0,
                                budget_p99_ms=50.0, replicas=2,
                                mix={"interactive": 5, "batch": 3,
                                     "best_effort": 2})
        capacity.emit(sink, dict(pred, verdict=capacity.verdict(pred, 900.0)))
        agg = fleet.FleetAggregator({"r0": replica, "gone": str(d / "x")},
                                    stale_after_s=60.0, sink=sink)
        agg.poll()
        agg.close()
        emit_traces(sink, sink)
        for f in (Finding("no_host_sync", "ERROR", "serve_step",
                          "1 host sync"),
                  Finding("donation", "WARN", "train_step", "not donated"),
                  Finding("budget", "INFO", "train_step", "within")):
            sink.emit(f.record())
        emit_profile(sink)
        for value, best in ((80.0, 100.0), (101.0, 100.0)):
            sink.emit({"metric": f"seps_{int(value)}", "platform": "gpu",
                       "value": value, "best": best,
                       "ratio": round(value / best, 4),
                       "regressed": value < 0.9 * best}, kind="regress")
    finally:
        sink.close()
    return {"run": path, "replica": replica, "client": client}


def test_emitted_sink_holds_every_kind(emitted):
    kinds = {r["kind"] for r in qm.read_jsonl(emitted["run"])}
    assert {"step_stats", "slo", "anomaly", "advice", "actuate", "serving",
            "tenant", "capacity", "fleet", "trace", "lint", "profile",
            "regress"} <= kinds
    assert os.path.exists(emitted["run"] + ".1")       # across the seam


# ---------------------------------------------------------------------------
# qt_top
# ---------------------------------------------------------------------------


def top_series(tmp_path):
    recs = [{"kind": "step_stats", "wall": {"p50_ms": 40.0 + i},
             "derived": {"hot_hit_rate": 0.8 - 0.02 * i}}
            for i in range(10)]
    recs += [
        {"kind": "anomaly", "series": "hot_hit_rate",
         "detector": "mean_shift", "baseline": 0.8, "value": 0.4,
         "step": 9},
        {"kind": "advice", "key": "hot_capacity", "current": 256,
         "recommended": 512, "reason": "shortfall"},
        {"kind": "regress", "metric": "seps", "platform": "cpu",
         "value": 80.0, "best": 100.0, "ratio": 0.8, "regressed": True},
    ]
    recs += [{"kind": "slo",
              "windows": {"short": {"burn_rate": 0.5 * k},
                          "long": {"burn_rate": 0.4 * k}},
              "budget_remaining": 0.1, "shedding": k == 4}
             for k in (1, 2, 4)]
    return [write_jsonl(tmp_path / "m.jsonl", recs)]


def top_seam(tmp_path):
    write_jsonl(tmp_path / "m.jsonl.1",
                [{"kind": "step_stats", "derived": {"hot_hit_rate": 0.9}}])
    return [write_jsonl(tmp_path / "m.jsonl",
                        [{"kind": "step_stats",
                          "derived": {"hot_hit_rate": 0.1}}])]


def top_empty(tmp_path):
    return [str(tmp_path / "nope.jsonl")]


def top_tenants(tmp_path):
    def tenant(name, prio, done, shed, rej, disp, p99, burn=None):
        rec = {"kind": "tenant", "tenant": name, "priority": prio,
               "completed": done, "shed": shed, "rejected": rej,
               "displaced": disp, "deadline_expired": 0,
               "latency": {"p99_ms": p99}}
        if burn is not None:
            rec["slo"] = {"windows": {"short": {"burn_rate": burn}}}
        return rec
    recs = [tenant("interactive", 2, 10, 0, 0, 0, 12.0, 0.4),
            tenant("interactive", 2, 25, 0, 0, 0, 11.0, 0.6),
            tenant("best_effort", 0, 5, 3, 2, 1, 80.0),
            {"kind": "replay", "tenant": "interactive",
             "latency": {"p99_ms": 14.0}},
            {"kind": "capacity", "replicas": 1, "predicted_rps": 2100.0,
             "budget_p99_ms": 100.0, "fill": 12.4, "batch_cap": 16,
             "verdict": {"within_tol": True, "measured_rps": 1980.0,
                         "ratio": 1.06}}]
    return [write_jsonl(tmp_path / "m.jsonl", recs)]


def fleet_recs():
    return [{"kind": "fleet",
             "replicas": {
                 "r0": {"health": 1.0 - 0.1 * i, "stale": False,
                        "age_s": 0.1, "records": 5 + i,
                        "components": {"burn": 0.5 + 0.2 * i,
                                       "shed_frac": 0.0}},
                 "r1": {"health": 0.0, "stale": True, "age_s": 9.9,
                        "records": 2,
                        "components": {"burn": None, "shed_frac": 0.0}}},
             "fleet": {"status": "degraded", "replica_count": 2,
                       "stale_count": 1, "health_min": 0.0,
                       "health_mean": 0.45 - 0.05 * i, "polls": i + 1}}
            for i in range(3)]


def top_fleet(tmp_path):
    return [write_jsonl(tmp_path / "fleet.jsonl", fleet_recs())]


def top_fleet_only(tmp_path):
    return [*top_fleet(tmp_path), "--fleet"]


def top_fleet_only_none(tmp_path):
    return [*top_series(tmp_path), "--fleet"]


def top_act(tmp_path):
    recs = [
        {"kind": "actuate", "key": "batch_cap", "action": "apply",
         "before": {"value": 8}, "after": {"value": 4}, "reason": "stale"},
        {"kind": "actuate", "key": "batch_cap", "action": "apply",
         "before": {"value": 4}, "after": {"value": 2},
         "reason": "mostly padding"},
        {"kind": "actuate", "key": "max_wait_ms", "action": "refuse",
         "level": "WARN", "recommended": 0.33, "before": {"value": 2.0},
         "reason": "outside lattice"},
        {"kind": "actuate", "key": "hot_set", "action": "rotate",
         "before": {"value": None}, "after": {"value": 12},
         "reason": "drift"},
        {"kind": "actuate", "key": "replicas", "action": "scale_up",
         "before": {"value": 2}, "after": {"value": 3},
         "reason": "pressure"},
    ]
    return [write_jsonl(tmp_path / "m.jsonl", recs)]


TOP_CASES = {
    "series_anomalies_advice": (top_series, (
        "hot_hit_rate", "ANOMALY [mean_shift]",
        "advice [hot_capacity]: 256 -> 512", "REGRESSED", "SHEDDING",
        "(n=3")),
    "rollover_seam": (top_seam, ("(2 records", "n=2")),
    "empty": (top_empty, ("no records yet",)),
    "tenants_capacity": (top_tenants, (
        "done 25", "shed 3 (rej 2 disp 1 ddl 0)", "tenant_burn:interactive",
        "replay_p99:interactive",
        "capacity: 1 replica(s) sustain 2100 req/s", "WITHIN TOL")),
    "fleet_in_default_view": (top_fleet, ("health:r0", "STALE")),
    "fleet_panel": (top_fleet_only, ("status degraded", "STALE",
                                     "health 0.8")),
    "fleet_panel_without_fleet": (top_fleet_only_none, ("no fleet records",)),
    "act_panel": (top_act, ("act [batch_cap] apply: 4 -> 2",
                            "act [max_wait_ms] refuse: 2.0 -> 0.33",
                            "act [hot_set] rotate",
                            "act [replicas] scale_up: 2 -> 3")),
}


@pytest.mark.parametrize("color", [False, True], ids=["plain", "color"])
@pytest.mark.parametrize("case", sorted(TOP_CASES))
def test_qt_top_equals_jaxs(case, color, tmp_path, capsys, monkeypatch,
                            frozen):
    make, needles = TOP_CASES[case]
    args = make(tmp_path)
    (jrc, jout), (rc, out) = run_both(
        "qt_top", ["--once", "--jsonl", *args], capsys, monkeypatch, color)
    assert rc == jrc == 0
    assert out == jout
    assert FROZEN_CLOCK in out
    assert ("\x1b[" in out) == color
    if not color:
        for needle in needles:
            assert needle in out, needle
    if case == "act_panel":
        assert "8 -> 4" not in out


@pytest.mark.parametrize("color", [False, True], ids=["plain", "color"])
@pytest.mark.parametrize("view", ["default", "fleet"])
def test_qt_top_over_the_ports_emitters(view, color, emitted, capsys,
                                        monkeypatch, frozen):
    argv = ["--once", "--jsonl", emitted["run"]]
    argv += ["--fleet"] if view == "fleet" else []
    (jrc, jout), (rc, out) = run_both("qt_top", argv, capsys, monkeypatch,
                                      color)
    assert rc == jrc == 0 and out == jout
    if color:
        return
    if view == "fleet":
        assert "fleet: 2 replicas, status " in out
        assert "  r0 " in out and "gone" in out
        return
    for needle in ("step_p50_ms", "hot_hit_rate", "slo_burn_short",
                   "slo: burn", "request_p99_ms", "queue_depth",
                   "tenant interactive p2", "capacity: 2 replica(s)",
                   "fleet: 2 replicas", "ANOMALY [", "advice [",
                   "act [batch_cap] apply: 8 -> 4",
                   "act [batch_cap] refuse", "lint ERROR [no_host_sync]",
                   "lint WARN [donation]", "prof [serve_step/copy]",
                   "prof [serve_step/gather]", "trace 104 [error]",
                   "regress [seps_80 @ gpu]", "REGRESSED"):
        assert needle in out, needle
    assert "lint INFO" not in out


# ---------------------------------------------------------------------------
# qt_trace
# ---------------------------------------------------------------------------


def trace_sink(tmp_path):
    recs = [
        {"ts": 1.0, "kind": "trace", "trace_id": 11,
         "policy": "latency_over_p99", "root": "serve.request",
         "replica": "r0", "duration_ms": 250.0,
         "spans": [{"name": "serve.dispatch", "t0_ms": 0.0,
                    "dur_ms": 200.0}],
         "dominant": {"name": "serve.dispatch", "dur_ms": 200.0},
         "queue_ms": 0.0, "execute_ms": 200.0},
        {"ts": 2.0, "kind": "trace", "trace_id": 11,
         "policy": "latency_over_p99", "root": "rpc.lookup",
         "replica": "client", "duration_ms": 260.0,
         "spans": [{"name": "rpc.attempt", "t0_ms": 0.0, "dur_ms": 255.0,
                    "args": {"attempt": 0}}],
         "dominant": {"name": "rpc.attempt", "dur_ms": 255.0},
         "queue_ms": 0.0, "execute_ms": 255.0},
        {"ts": 3.0, "kind": "trace", "trace_id": 12, "policy": "error",
         "root": "serve.request", "replica": "r0", "duration_ms": 5.0,
         "spans": [], "errors": ["OSError"], "dominant": None,
         "queue_ms": 0.0, "execute_ms": 0.0},
    ]
    return write_jsonl(tmp_path / "traces.jsonl", recs)


TRACE_ARGS = {
    "table": [], "slowest": ["--slowest", "1"], "errors": ["--errors"],
    "trace_id": ["--trace-id", "11"], "limit": ["--limit", "1"],
}


@pytest.mark.parametrize("color", [False, True], ids=["plain", "color"])
@pytest.mark.parametrize("case", sorted(TRACE_ARGS))
def test_qt_trace_equals_jaxs(case, color, tmp_path, capsys, monkeypatch,
                              frozen):
    argv = ["--jsonl", trace_sink(tmp_path), *TRACE_ARGS[case]]
    (jrc, jout), (rc, out) = run_both("qt_trace", argv, capsys, monkeypatch,
                                      color)
    assert rc == jrc == 0 and out == jout
    if color:
        return
    if case == "table":
        assert "2 kept traces" in out and "client+r0" in out
    if case == "errors":
        assert "  12 " in out and "  11 " not in out
    if case == "slowest":
        assert "  11 " in out and "  12 " not in out
    if case == "trace_id":
        assert "segment r0" in out and "segment client" in out


@pytest.mark.parametrize("case", ["table", "slowest", "errors", "trace_id"])
def test_qt_trace_over_the_ports_sinks(case, emitted, capsys, monkeypatch,
                                       frozen):
    extra = {"table": [], "slowest": ["--slowest", "2"],
             "errors": ["--errors"], "trace_id": ["--trace-id", "103"]}
    argv = ["--jsonl", emitted["client"], "--replicas",
            f"r0={emitted['replica']}", *extra[case]]
    (jrc, jout), (rc, out) = run_both("qt_trace", argv, capsys, monkeypatch,
                                      False)
    assert rc == jrc == 0 and out == jout
    assert "4 kept traces from 2 sink(s)" in out
    if case == "trace_id":
        assert "segment client" in out and "segment r0" in out


@pytest.mark.parametrize("case", ["one", "all"])
def test_qt_trace_export_equals_jaxs(case, tmp_path, capsys, monkeypatch,
                                     frozen):
    sink = trace_sink(tmp_path)
    pick = ["--trace-id", "11"] if case == "one" else []
    docs = []
    for who in ("jax", "port"):
        out_path = str(tmp_path / f"{who}.json")
        rc = (jax_script("qt_trace") if who == "jax" else qt_trace).main(
            ["--jsonl", sink, "--no-color", *pick, "--export", out_path])
        assert rc == 0
        text = capsys.readouterr().out
        assert f"-> {out_path}" in text
        with open(out_path) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    pids = {e["pid"] for e in docs[1]["traceEvents"]}
    assert len(pids) == (2 if case == "one" else 3)    # one a segment
    names = {e.get("name") for e in docs[1]["traceEvents"]}
    assert {"serve.dispatch", "rpc.attempt", "process_name"} <= names


def test_qt_trace_unknown_id_exits_nonzero(tmp_path, capsys, monkeypatch,
                                           frozen):
    argv = ["--jsonl", trace_sink(tmp_path), "--trace-id", "999"]
    (jrc, jout), (rc, out) = run_both("qt_trace", argv, capsys, monkeypatch,
                                      False)
    assert rc == jrc == 1 and out == jout
    assert "no matching traces" in out


# ---------------------------------------------------------------------------
# qt_agg
# ---------------------------------------------------------------------------


@pytest.fixture
def replica_sinks(tmp_path):
    paths = {}
    for i, name in enumerate(("serve-a", "serve-b")):
        p = str(tmp_path / f"{name}.jsonl")
        with qm.MetricsSink(p, replica=name) as sink:
            for step in range(3):
                sink.emit({"counters": {"hot_rows": 10 * (step + 1),
                                        "cold_rows": 5 * (step + 1 + i)},
                           "wall": {"p50_ms": 2.0 + i}}, kind="step_stats")
            sink.emit({"windows": {"short": {"burn_rate": 0.5 + 1.2 * i},
                                   "long": {"burn_rate": 0.2}},
                       "budget_remaining": 0.9}, kind="slo")
            if i:
                sink.emit({"serving": {"shed_level": 1,
                                       "fanout_variants": [[2], [1], [1]]}},
                          kind="serving")
        paths[name] = p
    return paths


@pytest.mark.parametrize("color", [False, True], ids=["plain", "color"])
def test_qt_agg_once_equals_jaxs(color, replica_sinks, tmp_path, capsys,
                                 monkeypatch, frozen):
    spec = ",".join(f"{n}={p}" for n, p in replica_sinks.items())
    outs, fleets = [], []
    for who, mod in (("jax", jax_script("qt_agg")), ("port", qt_agg)):
        events = str(tmp_path / f"events_{who}.jsonl")
        outs.append(run_one(mod, ["--once", "--replicas", spec,
                                  "--stale-after", "60", "--jsonl", events],
                            capsys, monkeypatch, color))
        fleets.append([r for r in qm.read_jsonl(events)
                       if r["kind"] == "fleet"])
    (jrc, jout), (rc, out) = outs
    assert rc == jrc == 0 and out == jout
    assert fleets[0] == fleets[1] and len(fleets[1]) == 1
    if not color:
        assert "serve-a: health 1.00" in out
        assert "serve-b: health 0.40" in out and "shed 0.50" in out
        assert "fleet: 2 replicas, status degraded" in out


@pytest.mark.parametrize("spec,want", [
    ("a=/x,b=/y", {"a": "/x", "b": "/y"}),
    ("/x,/y", {"r0": "/x", "r1": "/y"}),
    (" a=/x , /y ,", {"a": "/x", "r1": "/y"}),
    ("a=b=/c", {"a": "b=/c"}),
    ("a=/x,a=/y", "duplicate replica name 'a'"),
    ("", "need --replicas name=path[,name=path...]"),
    (" , ", "need --replicas name=path[,name=path...]"),
])
def test_qt_agg_parse_replicas_equals_jaxs(spec, want):
    jax_parse = jax_script("qt_agg")._parse_replicas
    if isinstance(want, dict):
        assert qt_agg._parse_replicas(spec) == jax_parse(spec) == want
        return
    with pytest.raises(SystemExit) as got:
        qt_agg._parse_replicas(spec)
    with pytest.raises(SystemExit) as ref:
        jax_parse(spec)
    assert str(got.value) == str(ref.value) == want


def test_qt_agg_check_exposition_on_the_ports_metrics(replica_sinks):
    agg = fleet.FleetAggregator(replica_sinks, stale_after_s=60.0)
    exp = fleet.FleetExporter(agg, port=0)
    try:
        agg.poll()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/metrics", timeout=10).read() \
            .decode()
    finally:
        exp.close()
        agg.close()
    jax_check = jax_script("qt_agg").check_exposition
    assert 'qt_replica_health{replica="serve-b"}' in body
    assert qt_agg.check_exposition(body) == jax_check(body) == []
    bad = body + "no_type_line 1\nbroken{ 2\n"
    assert qt_agg.check_exposition(bad) == jax_check(bad)
    assert len(qt_agg.check_exposition(bad)) == 2


def test_qt_agg_smoke(tmp_path, capsys):
    out = str(tmp_path / "fleet.jsonl")
    assert qt_agg.main(["--smoke", "--no-color", "--jsonl", out]) == 0
    text = capsys.readouterr().out
    assert "status ok" in text and "format OK" in text
    kinds = [r["kind"] for r in qm.read_jsonl(out)]
    assert "fleet" in kinds and "meta" in kinds


# ---------------------------------------------------------------------------
# qt_capacity
# ---------------------------------------------------------------------------


def capacity_history(path, with_capacity=True):
    with qm.MetricsSink(path, replica="r0") as sink:
        emit_serving(sink)
        if with_capacity:
            pred = capacity.predict(batch_cap=16, dispatch_ms=3.5,
                                    budget_p99_ms=50.0, replicas=3,
                                    overhead_per_req_ms=0.01,
                                    mix={"interactive": 5, "batch": 3,
                                         "best_effort": 2},
                                    probe={"gather_gbps": 2500.0},
                                    cost=4_000_000)
            capacity.emit(sink, dict(pred,
                                     verdict=capacity.verdict(pred, 800.0)))
    return path


@pytest.mark.parametrize("color", [False, True], ids=["plain", "color"])
def test_qt_capacity_render_equals_jaxs(color, tmp_path, capsys,
                                        monkeypatch, frozen):
    p = capacity_history(str(tmp_path / "h.jsonl"))
    (jrc, jout), (rc, out) = run_both("qt_capacity", ["--jsonl", p], capsys,
                                      monkeypatch, color)
    assert rc == jrc == 0 and out == jout
    assert ("\x1b[" in out) == color
    assert "capacity: 3 replica(s) sustain" in out
    assert "roofline floor" in out and "replay verdict" in out


def test_qt_capacity_without_records(tmp_path, capsys, monkeypatch, frozen):
    p = capacity_history(str(tmp_path / "h.jsonl"), with_capacity=False)
    (jrc, jout), (rc, out) = run_both("qt_capacity", ["--jsonl", p], capsys,
                                      monkeypatch, False)
    assert rc == jrc == 0 and out == jout
    assert out.startswith("no capacity records in ")


@pytest.mark.parametrize("knobs", [
    [],
    ["--batch-cap", "64", "--dispatch-ms", "4.5", "--replicas", "2",
     "--budget-ms", "80", "--max-wait-ms", "1.5", "--overhead-ms", "0.02",
     "--fill", "24", "--mix", "interactive=5,batch=3,best_effort=2"],
], ids=["observed", "knobs"])
def test_qt_capacity_predict_equals_jaxs(knobs, tmp_path, capsys,
                                         monkeypatch, frozen):
    p = capacity_history(str(tmp_path / "h.jsonl"), with_capacity=False)
    argv = ["--jsonl", p, "--predict", "--no-probe", *knobs]
    (jrc, jout), (rc, out) = run_both("qt_capacity", argv, capsys,
                                      monkeypatch, False)
    assert rc == jrc == 0 and out == jout
    assert f"capacity record appended -> {p}" in out
    caps = [r for r in qm.read_jsonl(p) if r["kind"] == "capacity"]
    assert len(caps) == 2                       # JAX's, then the port's
    jrec, rec = ({k: v for k, v in r.items() if k != "ts"} for r in caps)
    assert rec == jrec
    assert rec["source"] == "qt_capacity --predict"


def test_qt_capacity_predict_needs_knobs(tmp_path, capsys, monkeypatch,
                                         frozen):
    p = write_jsonl(tmp_path / "h.jsonl", [{"kind": "step_stats"}])
    argv = ["--jsonl", p, "--predict", "--no-probe"]
    (jrc, jout), (rc, out) = run_both("qt_capacity", argv, capsys,
                                      monkeypatch, False)
    assert rc == jrc == 1 and out == jout
    assert out.startswith("need --batch-cap and --dispatch-ms")


def test_qt_capacity_predict_with_the_cpu_probe(tmp_path, capsys,
                                                monkeypatch):
    from quiver_tpu_torch import profile
    probes = []

    def spy(**kw):
        probes.append(profile.machine_probe.__wrapped__(**kw))
        return probes[-1]
    spy.__wrapped__ = profile.machine_probe
    monkeypatch.setattr(profile, "machine_probe", spy)
    p = capacity_history(str(tmp_path / "h.jsonl"), with_capacity=False)
    argv = ["--jsonl", p, "--predict", "--no-color"]
    assert qt_capacity.main([*argv, "--device", "cpu"]) == 0
    assert qt_capacity.main([*argv, "--no-probe"]) == 0
    assert "capacity: 1 replica(s) sustain" in capsys.readouterr().out
    (probe,) = probes
    assert probe["platform"] == "cpu" and probe["gather_gbps"] > 0
    # without a cost the probe floors nothing: the same prediction
    a, b = ({k: v for k, v in r.items() if k != "ts"}
            for r in qm.read_jsonl(p) if r["kind"] == "capacity")
    assert a == b and a["floor_ms"] is None


def test_qt_capacity_probe_needs_a_card(tmp_path, capsys):
    """The probe runs on the card by default, with no CPU fallback: where
    there is none, ``--predict`` exits 1 and appends nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs there")
    p = capacity_history(str(tmp_path / "h.jsonl"), with_capacity=False)
    assert qt_capacity.main(["--jsonl", p, "--predict", "--no-color"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not [r for r in qm.read_jsonl(p) if r["kind"] == "capacity"]


# ---------------------------------------------------------------------------
# as a user runs them
# ---------------------------------------------------------------------------

_NO_TORCH = """
import runpy, sys
sys.argv = [sys.argv[1], *sys.argv[2:]]
rc = 0
try:
    runpy.run_module("quiver_tpu_torch.scripts." + sys.argv[0],
                     run_name="__main__")
except SystemExit as e:
    rc = e.code
print("MODULES", sorted(m for m in ("torch", "numpy") if m in sys.modules))
sys.exit(rc)
"""


@pytest.mark.parametrize("name", ["qt_top", "qt_trace"])
def test_stdlib_clis_import_no_torch(name, tmp_path):
    sink = trace_sink(tmp_path)
    args = ["--once"] if name == "qt_top" else []
    r = subprocess.run([sys.executable, "-c", _NO_TORCH, name, *args,
                        "--jsonl", sink, "--no-color"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "MODULES []" in r.stdout
    assert ("2 kept traces" if name == "qt_trace" else "(3 records") \
        in r.stdout


@pytest.mark.parametrize("name", ["qt_agg", "qt_capacity"])
def test_runs_as_a_module(name, replica_sinks, tmp_path):
    if name == "qt_agg":
        args = ["--once", "--replicas",
                ",".join(f"{n}={p}" for n, p in replica_sinks.items())]
    else:
        args = ["--jsonl", capacity_history(str(tmp_path / "h.jsonl"))]
    env = dict(os.environ, QT_METRICS_JSONL=str(tmp_path / "events.jsonl"))
    r = subprocess.run([sys.executable, "-m",
                        f"quiver_tpu_torch.scripts.{name}", *args,
                        "--no-color"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert ("fleet: 2 replicas" if name == "qt_agg" else
            "capacity: 3 replica(s)") in r.stdout
    if name == "qt_agg":                  # --jsonl from QT_METRICS_JSONL
        assert any(rec["kind"] == "fleet" for rec in
                   qm.read_jsonl(str(tmp_path / "events.jsonl")))
