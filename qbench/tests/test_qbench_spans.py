"""The readers of the program's spans (``source: program_span``) against a
synthetic span ring: the traced slice's units are the first root spans of
the ring, a span's device time comes from its events and its counters
from its mark; a ring with no spans, or fewer units than the slice
traced, reads nothing."""

import pytest

from qbench import spec, trace

SPAN_METRICS = ("pool_draw_ms.train", "compact_ms.train", "lookup_ms.train",
                "step_ms.train", "host_ms.train", "walk_ms.serve",
                "cold_fixup_ms.serve", "host_rows.serve", "host_ms.serve")


class _Events:
    """A span's device events as the program's torch side hands them
    over: ``elapsed()`` milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed(self):
        return self.ms


class _Ring:
    """Files records into the process tracer's ring as spans would."""

    def __init__(self, tracing):
        self.tracing = tracing
        self.sid = 0
        self.t = 0.0

    def span(self, name, host_ms, dev_ms=None, parent=None, **counts):
        self.sid += 1
        mark = self.tracing.Mark(
            _Events(dev_ms) if dev_ms is not None else None, counts or None)
        self.tracing.get_tracer()._file(name, self.t, host_ms / 1e3, None,
                                        None, self.sid, parent, mark)
        self.t += host_ms / 1e3
        return self.sid


@pytest.fixture
def ring():
    tracing = pytest.importorskip("quiver_tpu_torch.tracing")
    if not hasattr(tracing, "per_unit"):
        pytest.skip("the program records no spans")
    tracing.clear()
    yield _Ring(tracing)
    tracing.clear()


def _readers():
    return spec.metric_readers(list(SPAN_METRICS))


def _train_steps(ring, n, extra=0):
    """``n`` traced steps then ``extra`` more (the host slice's)."""
    for k in range(n + extra):
        s = ring.span("sampler.sample", 2.0, dev_ms=16.0)
        for hop in range(3):
            ring.span("sample.draw", 0.3, dev_ms=3.0 + k, parent=s)
            ring.span("sample.compact", 0.1, dev_ms=1.0, parent=s)
        ring.span("feature.lookup", 0.05, dev_ms=0.5)
        t = ring.span("train.step", 3.0, dev_ms=10.0)
        ring.span("train.forward", 1.0, dev_ms=3.0, parent=t)


def _serve_batches(ring, n):
    for k in range(n):
        r = ring.span("serve.run", 8.0, dev_ms=14.0)
        ring.span("serve.walk", 3.0, dev_ms=6.0, parent=r)
        f = ring.span("serve.cold_fixup", 2.0, dev_ms=4.0, parent=r)
        ring.span("feature.lookup", 1.5, dev_ms=3.5, parent=f,
                  host_rows=490_000 + k, cold_slots=800_000,
                  dedup_overflow=0)
        ring.span("serve.model", 2.0, dev_ms=3.0, parent=r)


def test_every_span_metric_is_declared_with_its_source():
    bench = spec.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert declared[name]["source"] == "program_span"
        assert declared[name]["better"] == "lower"


def test_train_readers_on_a_synthetic_ring(ring):
    _train_steps(ring, 2, extra=1)
    s = trace.Slice([], 0.1, 2)
    r = _readers()
    # the first two steps: draws 3*3 and 3*4 ms a step
    assert r["pool_draw_ms.train"].read(s) == pytest.approx(10.5)
    assert r["compact_ms.train"].read(s) == pytest.approx(3.0)
    assert r["lookup_ms.train"].read(s) == pytest.approx(0.5)
    assert r["step_ms.train"].read(s) == pytest.approx(10.0)
    assert r["host_ms.train"].read(s) == pytest.approx(5.05)
    for name in ("walk_ms.serve", "cold_fixup_ms.serve", "host_rows.serve",
                 "host_ms.serve"):
        assert r[name].read(s) is None, name


def test_serve_readers_on_a_synthetic_ring(ring):
    _serve_batches(ring, 3)
    s = trace.Slice([], 0.1, 2)
    r = _readers()
    assert r["walk_ms.serve"].read(s) == pytest.approx(6.0)
    assert r["cold_fixup_ms.serve"].read(s) == pytest.approx(4.0)
    assert r["host_rows.serve"].read(s) == pytest.approx(490_000.5)
    assert r["host_ms.serve"].read(s) == pytest.approx(8.0)
    assert r["step_ms.train"].read(s) is None


@pytest.mark.parametrize("units", [0, 2, 5])
def test_readers_of_an_empty_or_short_ring_read_nothing(ring, units):
    if units == 5:
        _train_steps(ring, 2)
        _serve_batches(ring, 2)
    s = trace.Slice([], 0.1, units)
    for name, mod in _readers().items():
        assert mod.read(s) is None, name


def test_a_step_without_device_events_reads_no_device_time(ring):
    for _ in range(2):
        ring.span("train.step", 3.0)
    s = trace.Slice([], 0.1, 2)
    assert _readers()["step_ms.train"].read(s) is None
