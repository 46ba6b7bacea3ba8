"""The port's capacity model (``quiver_tpu_torch/capacity.py``) against
the JAX package's (``quiver_tpu/capacity.py``): ``predict`` records
equal over a grid of inputs (the fill fixed point, a pinned fill, the
byte floor in each of its forms, tenant mixes, the host-bound cycle),
the same argument errors, ``observe_serving`` over one record stream,
``verdict`` and the ``capacity`` record ``emit`` writes."""

import itertools

import pytest

from quiver_tpu import capacity as jcapacity
from quiver_tpu_torch import capacity
from quiver_tpu_torch import metrics as qm


class _Cost:
    total_bytes = 180_000_000


GRID = list(itertools.product(
    [1, 64, 1024],                   # batch_cap
    [0.4, 12.5, 60.0],               # dispatch_ms
    [20.0, 100.0],                   # budget_p99_ms
    [1, 3],                          # replicas
    [0.0, 0.02]))                    # overhead_per_req_ms


@pytest.mark.parametrize("cap,dispatch,budget,replicas,overhead", GRID)
def test_predict_equals_jaxs(cap, dispatch, budget, replicas, overhead):
    kw = dict(batch_cap=cap, dispatch_ms=dispatch, budget_p99_ms=budget,
              replicas=replicas, overhead_per_req_ms=overhead,
              max_wait_ms=2.0)
    assert capacity.predict(**kw) == jcapacity.predict(**kw)


@pytest.mark.parametrize("cost", [None, 180_000_000, 2.5e8,
                                  {"total_bytes": 90_000_000},
                                  {"other": 1}, _Cost()])
@pytest.mark.parametrize("probe", [None, {}, {"gather_gbps": 0.0},
                                   {"gather_gbps": 2400.0}])
def test_floor_equals_jaxs(cost, probe):
    kw = dict(batch_cap=1024, dispatch_ms=0.05, budget_p99_ms=50.0,
              cost=cost, probe=probe, mix={"interactive": 2.0, "batch": 1.0},
              fill=300.0)
    assert capacity.predict(**kw) == jcapacity.predict(**kw)


@pytest.mark.parametrize("kw", [
    dict(batch_cap=0, dispatch_ms=1.0, budget_p99_ms=10.0),
    dict(batch_cap=8, dispatch_ms=1.0, budget_p99_ms=10.0, replicas=0),
    dict(batch_cap=8, dispatch_ms=0.0, budget_p99_ms=10.0),
    dict(batch_cap=8, dispatch_ms=1.0, budget_p99_ms=0.0),
    dict(batch_cap=8, dispatch_ms=1.0, budget_p99_ms=10.0,
         overhead_per_req_ms=-1.0),
    dict(batch_cap=8, dispatch_ms=1.0, budget_p99_ms=10.0,
         mix={"a": 0.0}),
])
def test_predict_errors_equal_jaxs(kw):
    with pytest.raises(ValueError) as got:
        capacity.predict(**kw)
    with pytest.raises(ValueError) as want:
        jcapacity.predict(**kw)
    assert str(got.value) == str(want.value)


RECORDS = [
    {"kind": "meta", "pid": 1},
    {"kind": "serving", "wall": {"p50_ms": 3.25},
     "serving": {"mean_batch_fill": 211.5,
                 "knobs": {"max_wait_ms": 2.0, "batch_fill_cap": 512}}},
    {"kind": "slo", "wall": {"p50_ms": 99.0}},
    {"wall": {"p50_ms": 4.5}, "serving": {"knobs": {"max_wait_ms": 1.0}}},
    {"kind": "serving", "serving": {"mean_batch_fill": 0}},
]


@pytest.mark.parametrize("n", range(len(RECORDS) + 1))
def test_observe_serving_equals_jaxs(n):
    assert capacity.observe_serving(RECORDS[:n]) == \
        jcapacity.observe_serving(RECORDS[:n])


@pytest.mark.parametrize("measured,tol", [(100.0, 0.25), (1234.5, 0.1),
                                          (37.0, 0.5)])
def test_verdict_and_emit_equal_jaxs(tmp_path, measured, tol):
    pred = capacity.predict(batch_cap=1024, dispatch_ms=60.0,
                            budget_p99_ms=150.0, replicas=3)
    assert pred == jcapacity.predict(batch_cap=1024, dispatch_ms=60.0,
                                     budget_p99_ms=150.0, replicas=3)
    got = capacity.verdict(pred, measured, tol)
    assert got == jcapacity.verdict(pred, measured, tol)
    with pytest.raises(ValueError, match="measured_rps"):
        capacity.verdict(pred, 0.0)
    path = tmp_path / "cap.jsonl"
    with qm.MetricsSink(str(path)) as sink:
        rec = capacity.emit(sink, {**pred, "verdict": got})
    read = [r for r in qm.read_jsonl(str(path))
            if r.get("kind") == "capacity"]
    assert len(read) == 1 and read[0]["verdict"] == got
    assert rec["kind"] == "capacity"
