"""The port's trace replay (``quiver_tpu_torch/traffic.py``) against the
JAX package's (``quiver_tpu/traffic.py``), adapted from
``tests/test_traffic.py``:

- every scenario's trace equals JAX's array for array (times, tenants,
  nodes) for several seeds and knobs, and so does every ``[lo, hi)``
  slice, which also assembles the whole trace;
- the argument checks raise the same errors;
- a replay against a deterministic stub (rejects, deadline expiries and
  failures by tenant) gives the same per-tenant counts through both
  packages and the hand fold, and the port's ``replay`` records; the
  port server's ``OverloadError`` counts as a reject."""

import concurrent.futures
import os

import numpy as np
import pytest

from quiver_tpu import rpc as jrpc
from quiver_tpu import traffic as jtraffic
from quiver_tpu_torch import metrics as qm
from quiver_tpu_torch import rpc as qrpc
from quiver_tpu_torch import traffic

SCENARIO_KW = {
    "steady": {},
    "diurnal": {"diurnal_amp": 0.7},
    "flash_crowd": {"flash_x": 8.0},
    "hot_storm": {"storm_frac": 0.9},
}
ARRAYS = ("t", "tenant", "node")


def _same(a, b):
    for k in ARRAYS:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in set(a) - set(ARRAYS):
        assert a[k] == b[k], k


def test_names_equal_jaxs():
    assert traffic.SCENARIO_NAMES == jtraffic.SCENARIO_NAMES
    assert traffic.DEFAULT_MIX == jtraffic.DEFAULT_MIX


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("name", traffic.SCENARIO_NAMES)
def test_trace_equals_jaxs(name, seed):
    kw = SCENARIO_KW[name]
    got = traffic.generate_scenario(name, 20.0, 40.0, 500, seed=seed, **kw)
    want = jtraffic.generate_scenario(name, 20.0, 40.0, 500, seed=seed,
                                      **kw)
    _same(got, want)
    assert got["length"] == len(got["t"]) > 0


@pytest.mark.parametrize("name", traffic.SCENARIO_NAMES)
def test_trace_with_knobs_equals_jaxs(name):
    kw = dict(mix={"a": 1.0, "b": 3.0, "best_effort": 0.5}, skew=1.5,
              flash_start_frac=0.2, flash_dur_frac=0.5,
              storm_region_frac=0.1, diurnal_period_s=7.0)
    got = traffic.generate_scenario(name, 12.0, 25.0, 9000, seed=5, **kw)
    want = jtraffic.generate_scenario(name, 12.0, 25.0, 9000, seed=5, **kw)
    _same(got, want)


@pytest.mark.parametrize("name", traffic.SCENARIO_NAMES)
def test_slices_equal_jaxs_and_assemble(name):
    """Blocks of the generator are 8,192 draws: slices across block
    edges, one element, and empty ones."""
    kw = SCENARIO_KW[name]
    whole = traffic.generate_scenario(name, 400.0, 50.0, 700, seed=2, **kw)
    n = whole["length"]
    cuts = [0, 1, 8191, 8192, 8193, 12000, n - 1, n]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        got = traffic.generate_scenario(name, 400.0, 50.0, 700, seed=2,
                                        lo=lo, hi=hi, **kw)
        want = jtraffic.generate_scenario(name, 400.0, 50.0, 700, seed=2,
                                          lo=lo, hi=hi, **kw)
        _same(got, want)
        for k in ARRAYS:
            np.testing.assert_array_equal(got[k], whole[k][lo:hi])
    empty = traffic.generate_scenario(name, 400.0, 50.0, 700, seed=2,
                                      lo=5, hi=5, **kw)
    assert all(len(empty[k]) == 0 for k in ARRAYS)


@pytest.mark.parametrize("args,kw", [
    (("nope", 1.0, 1.0, 10), {}),
    (("steady", -1.0, 1.0, 10), {}),
    (("steady", 1.0, 0.0, 10), {}),
    (("steady", 1.0, 1.0, 0), {}),
    (("steady", 1.0, 1.0, 10), {"seed": -1}),
    (("steady", 1.0, 1.0, 10), {"mix": {"a": 0.0}}),
    (("flash_crowd", 1.0, 1.0, 10), {"flash_tenant": "x"}),
    (("flash_crowd", 1.0, 1.0, 10), {"flash_x": 0.5}),
    (("diurnal", 1.0, 1.0, 10), {"diurnal_amp": 1.5}),
    (("hot_storm", 10.0, 10.0, 10), {"storm_frac": 2.0}),
    (("steady", 10.0, 10.0, 10), {"lo": 80, "hi": 20}),
])
def test_argument_errors_equal_jaxs(args, kw):
    with pytest.raises(ValueError) as got:
        traffic.generate_scenario(*args, **kw)
    with pytest.raises(ValueError) as want:
        jtraffic.generate_scenario(*args, **kw)
    assert str(got.value) == str(want.value)


class _Stub:
    """Every 3rd best_effort submit overloads, every 4th interactive
    expires its deadline, every 5th batch submit fails; the rest resolve
    at once (``tests/test_traffic.py``'s stub, over either package's
    typed errors)."""

    def __init__(self, rpc):
        self.rpc = rpc
        self.seen = {"interactive": 0, "batch": 0, "best_effort": 0}

    def submit(self, node, tenant=None):
        self.seen[tenant] += 1
        k = self.seen[tenant]
        if tenant == "best_effort" and k % 3 == 0:
            raise self.rpc.Overloaded("stub shed")
        if tenant == "interactive" and k % 4 == 0:
            raise self.rpc.DeadlineExceeded("stub deadline")
        if tenant == "batch" and k % 5 == 0:
            raise RuntimeError("stub fault")
        fut = concurrent.futures.Future()
        fut.set_result(np.full((3,), float(node), np.float32))
        return fut


COUNTS = ("offered", "accepted", "rejected", "failed", "deadline_expired",
          "completed")


def test_replay_accounting_equals_jaxs(tmp_path):
    trace = traffic.generate_scenario("steady", 200.0, 3.0, 50, seed=11)
    path = os.fspath(tmp_path / "replay.jsonl")
    with qm.MetricsSink(path) as sink:
        got = traffic.replay(trace, _Stub(qrpc), speed=4000.0, sink=sink)
    want = jtraffic.replay(trace, _Stub(jrpc), speed=4000.0)
    names = [trace["tenants"][i] for i in trace["tenant"]]
    fold = {n: dict.fromkeys(COUNTS, 0) for n in trace["tenants"]}
    seen = dict.fromkeys(trace["tenants"], 0)
    for n in names:
        w = fold[n]
        w["offered"] += 1
        seen[n] += 1
        if n == "best_effort" and seen[n] % 3 == 0:
            w["rejected"] += 1
        elif n == "interactive" and seen[n] % 4 == 0:
            w["deadline_expired"] += 1
        elif n == "batch" and seen[n] % 5 == 0:
            w["failed"] += 1
        else:
            w["completed"] += 1
            w["accepted"] += 1
    for n in trace["tenants"]:
        for k in COUNTS:
            assert got["tenants"][n][k] == want["tenants"][n][k] \
                == fold[n][k], (n, k)
        assert got["tenants"][n]["latency"]["n"] == fold[n]["completed"]
    assert sorted(got["tenants"]) == sorted(want["tenants"])
    recs = [r for r in qm.read_jsonl(path) if r.get("kind") == "replay"]
    assert sorted(r["tenant"] for r in recs) == sorted(trace["tenants"])
    assert all(r["offered"] == fold[r["tenant"]]["offered"] for r in recs)


def test_sync_callable_and_server_overload():
    from quiver_tpu_torch.serving import OverloadError

    class _Shedder:
        def submit(self, node, tenant=None):
            raise OverloadError("full")

    trace = traffic.generate_scenario("steady", 50.0, 2.0, 20, seed=2)
    calls = []
    rep = traffic.replay(trace, lambda node, tenant:
                         calls.append((node, tenant)), speed=2000.0)
    assert sum(t["completed"] for t in rep["tenants"].values()) \
        == len(calls) == trace["length"]
    assert [c[0] for c in calls] == trace["node"].tolist()
    shed = traffic.replay(trace, _Shedder(), speed=2000.0)
    assert sum(t["rejected"] for t in shed["tenants"].values()) \
        == trace["length"]
    with pytest.raises(ValueError, match="speed"):
        traffic.replay(trace, lambda n, t: None, speed=0.0)
