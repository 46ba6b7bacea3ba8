"""The port's tail sampler (``quiver_tpu_torch/tailsampling.py``) against
the JAX package's (``quiver_tpu/tailsampling.py``), adapted from
``tests/test_tailsampling.py``: one seeded span stream (request traces
with errors, deadlines, slow roots, batch spans, evictions and
truncations, an anomaly window on a fake clock, a seeded head-sampling
floor) offered through each package's tracer to each package's sampler
keeps the same traces with the same records and stats; the critical
path, the cross-process assembly, the ``TraceStore`` and the Chrome
events are equal on the same records; ``latency_source_from`` and
``watch_hub`` behave alike."""

import random

import numpy as np
import pytest

from quiver_tpu import tailsampling as jtail
from quiver_tpu import tracing as jtracing
from quiver_tpu_torch import tailsampling, tracing
from quiver_tpu_torch.metrics import SloBudget, StepStats

ROOTS = ("serve.request", "rpc.lookup")
INNER = ("serve.admission_wait", "serve.coalesce_wait", "rpc.attempt",
         "rpc.backoff", "pipeline.execute", "scope.gather")
BATCH = ("serve.batch_coalesce", "serve.dispatch", "serve.scatter")
ERRORS = (None, None, None, None, "DeadlineExceeded", "OSError")


class ListSink:
    def __init__(self):
        self.records = []

    def emit(self, rec, kind=None):
        self.records.append(dict(rec, kind=kind))
        return rec


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def stream(seed, traces=200):
    """Seeded spans ``(name, t0, dur, trace_id, args)`` and the clock
    times at which to arm an anomaly window."""
    rng = random.Random(seed)
    out = []
    t = 0.0
    open_ids = []
    for i in range(traces):
        tid = 1000 + i
        open_ids.append(tid)
        for _ in range(rng.randrange(0, 5)):
            t += 0.0005
            out.append((rng.choice(INNER), t, rng.random() * 0.01,
                        rng.choice(open_ids), None))
        if rng.random() < 0.3:
            bid = 5000 + rng.randrange(20)
            for name in BATCH:
                t += 0.0002
                out.append((name, t, rng.random() * 0.004, bid,
                            {"fill": rng.randrange(1, 64)}))
        if rng.random() < 0.8 and open_ids:
            root = open_ids.pop(rng.randrange(len(open_ids)))
            err = rng.choice(ERRORS)
            args = {"batch": 5000 + rng.randrange(20)}
            if err:
                args["error"] = err
            t += 0.001
            out.append((rng.choice(ROOTS), t, rng.random() * 0.2, root,
                        args))
        if rng.random() < 0.05:
            out.append((rng.choice(INNER), t, 0.001, None, None))
    return out


def run(pkg, tr, spans, arm_at, **kw):
    """Offer ``spans`` through a ``pkg`` tracer to a ``pkg`` sampler;
    arm the anomaly window before span ``arm_at``."""
    sink, clock = ListSink(), Clock()
    tracer = tr.Tracer(capacity=64)
    s = pkg.TailSampler(sink=sink, clock=clock, **kw).attach(tracer)
    for i, (name, t0, dur, tid, args) in enumerate(spans):
        clock.t = i * 0.01
        if i == arm_at:
            s.arm_anomaly_window(0.5)
        tracer.record(name, t0, dur, tid, args)
    s.detach()
    tracer.record("serve.request", 0.0, 1.0, 7, {"error": "OSError"})
    return sink.records, s.stats()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [
    dict(head_rate=0.0),
    dict(head_rate=0.2, seed=5, latency_source=lambda: 150.0),
    dict(max_pending=8, max_spans_per_trace=3, max_batches=4,
         head_rate=0.05, seed=1, latency_source=lambda: None),
])
def test_keep_decisions_and_records_equal_jaxs(seed, kw):
    spans = stream(seed)
    got = run(tailsampling, tracing, spans, 150, **kw)
    want = run(jtail, jtracing, spans, 150, **kw)
    # the port's records also name their clock base: the first kept
    # span's start in Unix nanoseconds (tracing.unix_ns)
    lo, hi = tracing.unix_ns(0.0), tracing.unix_ns(spans[-1][1])
    assert all(isinstance(b, int) and lo <= b <= hi
               for b in (r.pop("base_ns") for r in got[0]))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["kept"] == len(got[0]) > 0
    assert got[1]["completed"] > got[1]["kept"] or kw["head_rate"] == 0.2


def test_policy_names_and_argument_errors():
    assert tailsampling.TAIL_POLICY_NAMES == jtail.TAIL_POLICY_NAMES
    for kw in (dict(max_pending=0), dict(head_rate=1.5)):
        with pytest.raises(ValueError) as got:
            tailsampling.TailSampler(**kw)
        with pytest.raises(ValueError) as want:
            jtail.TailSampler(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tailsampling.TraceStore(capacity=0)


def test_attach_enables_and_detach_unhooks():
    tracer = tracing.Tracer(capacity=16)
    s = tailsampling.TailSampler().attach(tracer)
    assert tracer.enabled and tracer.sampler() is s
    s.detach()
    assert tracer.sampler() is None
    tracer.record("serve.request", 0.0, 0.001, 1)
    assert s.stats()["completed"] == 0


def _kept(seed):
    recs, _ = run(tailsampling, tracing, stream(seed), 10, head_rate=0.3,
                  seed=seed)
    return [{k: v for k, v in r.items() if k not in ("kind", "base_ns")}
            for r in recs]


@pytest.mark.parametrize("seed", range(3))
def test_critical_path_assembly_and_chrome_equal_jaxs(seed):
    recs = _kept(seed)
    assert recs
    for r in recs:
        for root in (None, r["root"]):
            assert tailsampling.critical_path(
                r["spans"], root, r["duration_ms"]) == \
                jtail.critical_path(r["spans"], root, r["duration_ms"])
        assert tailsampling.trace_record_to_chrome_events(r, pid=3) == \
            jtail.trace_record_to_chrome_events(r, pid=3)
    # one trace from two processes: a client segment and a replica's
    client = dict(recs[0], root="rpc.lookup", replica=None)
    replica = dict(recs[-1], trace_id=recs[0]["trace_id"],
                   root="serve.request", replica="r1")
    assert tailsampling.assemble(recs[0]["trace_id"], [replica, client]) \
        == jtail.assemble(recs[0]["trace_id"], [replica, client])


def test_trace_store_equals_jaxs():
    recs = _kept(1) + _kept(2)
    got, want = tailsampling.TraceStore(8), jtail.TraceStore(8)
    for i, r in enumerate(recs + recs[:5]):
        src = f"r{i % 3}"
        assert got.add(r, src) == want.add(r, src)
    assert got.trace_ids() == want.trace_ids()
    assert (len(got), got.added, got.evicted) == \
        (len(want), want.added, want.evicted)
    assert got.assembled() == want.assembled()
    assert got.assembled(limit=2) == want.assembled(limit=2)
    for name in (None, "r0", "r1", "r9"):
        assert got.latest(name) == want.latest(name)
    tid = got.trace_ids()[0]
    assert got.get(tid) == want.get(tid)
    assert got.get(-5) is None


def test_latency_source_from():
    slo = SloBudget(target_p99_ms=40.0)
    assert tailsampling.latency_source_from(slo=slo)() == 40.0
    assert tailsampling.latency_source_from(slo=slo, floor_ms=90.0)() == 90.0
    stats = StepStats()
    src = tailsampling.latency_source_from(stats=stats)
    assert src() is None
    for ms in np.linspace(1, 100, 200):
        stats.record_request(ms / 1e3)
    assert src() == pytest.approx(stats.request_p99_ms())
    assert tailsampling.latency_source_from()() is None


def test_watch_hub_arms_the_window():
    from quiver_tpu_torch.telemetry import TelemetryHub
    clock = Clock()
    hub = TelemetryHub(window=2, watches=(("x", "spike", {}),))
    s = tailsampling.TailSampler(clock=clock, anomaly_window_s=5.0)
    s.watch_hub(hub)
    s.offer("serve.request", 1, 0.0, 0.001, 11, None)
    hub.observe("x", 3.0)                   # a spike: the window arms
    s.offer("serve.request", 1, 0.0, 0.001, 12, None)
    clock.t = 6.0
    s.offer("serve.request", 1, 0.0, 0.001, 13, None)
    st = s.stats()
    assert st["kept_by_policy"] == {"anomaly_window": 1}
    assert st["dropped"] == 2
