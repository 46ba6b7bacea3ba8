"""The port's actuator (``quiver_tpu_torch/actuator.py``) against the
JAX package's (``quiver_tpu/actuator.py``), adapted from
``tests/test_actuator.py``:

- ``Knob.snap`` and ``lattice_from_census`` (duck-typed on
  ``spec.axes``) give the same points and errors;
- one script of advice under a fake clock (oscillation inside a
  cooldown, refusals outside the lattice, settling, ``flush``) through
  both packages gives the same records and counts;
- on the same stores (fp32 and int8) and the same served-id census, the
  same promote and demote sets, and the rotated store's rows equal
  the store's before the rotation and a store built with the rotated
  hot set, bit for bit; an engine refreshed after the rotation serves
  the same logits;
- the server knobs through a live ``MicroBatchServer``: the default
  lattices, a swap inside applies, one outside is refused with a WARN
  ``actuate`` record; ``plan_fleet`` applies the planned floor;
- ``FleetAutoscaler`` trajectories and records equal JAX's under a fake
  clock and inert processes (``chip_smoke.autoscale_pass``), the first
  pinned as the trajectory phase 16 (b) checks on the card."""

import types

import numpy as np
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu import actuator as jact
from quiver_tpu import fleet as jf
from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, MicroBatchServer,
                              ServeConfig, ServeEngine)
from quiver_tpu_torch import actuator as act
from quiver_tpu_torch import fleet as qf
from quiver_tpu_torch.ops import quant

N, DIM, HIDDEN, OUT = 200, 8, 16, 5
HOT = 50
SIZES, CAP, ROW_CAP = [3, 2], 8, 16


def test_keys_snap_and_census_equal_jaxs():
    assert act.ACTUATION_KEYS == jact.ACTUATION_KEYS
    lattices = [(1, 2, 4, 8), (0.25, 0.5, 1.0, 2.0), ("a", 3, 2.5)]
    probes = [4, 4.0, 0.5, 0.5000000000001, 3, 7, "a", None, "x", 2.5]
    for lat in lattices:
        got = act.Knob("k", read=lambda: None, apply=lambda v: None,
                       lattice=lat)
        want = jact.Knob("k", read=lambda: None, apply=lambda v: None,
                         lattice=lat)
        assert [got.snap(p) for p in probes] == \
            [want.snap(p) for p in probes]
    spec = types.SimpleNamespace(axes={"cap": [8, 16, 32], "n": 4,
                                       "none": None, "s": "abc"})
    assert act.lattice_from_census(spec, "cap") == \
        jact.lattice_from_census(spec, "cap") == (8, 16, 32)
    for axis, exc in (("nope", KeyError), ("n", ValueError),
                      ("none", ValueError), ("s", ValueError)):
        with pytest.raises(exc) as got:
            act.lattice_from_census(spec, axis)
        with pytest.raises(exc) as want:
            jact.lattice_from_census(spec, axis)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="empty lattice"):
        act.Actuator().register(act.Knob("k", read=None, apply=None,
                                          lattice=()))


class _Hub:
    def __init__(self):
        self.advice = {}

    def replan(self):
        return list(self.advice.values())

    def snapshot(self):
        return {"derived": {}}


def _adv(key, rec, observed=None):
    return {"key": key, "current": None, "recommended": rec,
            "observed": observed or {}, "reason": "test"}


def _script(mod):
    clk = [0.0]
    val = {"batch_cap": 4, "max_wait_ms": 2.0}
    hub = _Hub()
    a = mod.Actuator(hub=hub, clock=lambda: clk[0], cooldown_s=30.0,
                     settle_s=5.0)
    a.register(mod.Knob("batch_cap", read=lambda: val["batch_cap"],
                        apply=lambda v: val.__setitem__("batch_cap", v),
                        lattice=(1, 2, 4, 8)))
    a.register(mod.Knob("max_wait_ms", read=lambda: val["max_wait_ms"],
                        apply=lambda v: val.__setitem__("max_wait_ms", v),
                        lattice=(0.5, 1.0, 2.0, 4.0), cooldown_s=3.0))
    out = []
    for i in range(60):
        clk[0] = float(i)
        hub.advice["batch_cap"] = _adv(
            "batch_cap", 8 if val["batch_cap"] == 4 else 4,
            {"fill_p95": float(i)})
        hub.advice["max_wait_ms"] = _adv(
            "max_wait_ms", [1.0, 0.33, 4.0, 2.0][i % 4], {"p99": i})
        out.append(a.tick())
        out.append(a.tick([_adv("batch_cap", 7), _adv("other", 1)]))
    out.append(a.flush())
    out.append((a.snapshot(), a.records, dict(val)))
    return out


def test_advice_script_equals_jaxs():
    got, want = _script(act), _script(jact)
    assert got == want
    actions = {r["action"] for r in got[-1][1]}
    assert actions == {"apply", "refuse", "suppress"}


def _graph():
    g = np.random.default_rng(0)
    deg = g.integers(0, 20, N)
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    return indptr, g.integers(0, N, indptr[-1]).astype(np.int32)


def _table():
    return np.random.default_rng(1).standard_normal((N, DIM)) \
        .astype(np.float32)


def _port_store(policy, order=None):
    indptr, indices = _graph()
    return Feature(device_cache_size=HOT * quant.row_bytes(DIM, policy),
                   dtype_policy=policy,
                   csr_topo=CSRTopo(indptr=indptr, indices=indices,
                                    device="cpu"),
                   device="cpu").from_cpu_tensor(_table())


def _jax_store(policy):
    indptr, indices = _graph()
    j = qv.Feature(device_cache_size=HOT * quant.row_bytes(DIM, policy),
                   dtype_policy=policy,
                   csr_topo=qv.CSRTopo(indptr=indptr, indices=indices))
    j.from_cpu_tensor(_table())
    return j


def _census(store):
    """Served ids that hammer some cold rows and touch some hot ones."""
    order = store._order_host()
    cold = np.nonzero(order >= store.cache_rows)[0]
    hot = np.nonzero(order < store.cache_rows)[0]
    g = np.random.default_rng(5)
    return [np.concatenate([g.choice(cold[:30], 40), g.choice(hot, 10),
                            [-1, -1]]) for _ in range(6)]


def _rotate(mod, store, batches, **kw):
    clk = [100.0]
    a = mod.Actuator(clock=lambda: clk[0])
    for b in batches:
        a.observe_ids(b, total_rows=N)
    census = a.hit_census()
    calls = []
    inner = store.rotate_hot_set

    def spy(promote, demote):
        calls.append((np.asarray(promote).tolist(),
                      np.asarray(demote).tolist()))
        return inner(promote, demote)
    store.rotate_hot_set = spy
    rec = a.maybe_rotate(store, **kw)
    return rec, calls, census, a.hit_census()


@pytest.mark.parametrize("policy", [None, "int8"])
@pytest.mark.parametrize("kw", [dict(max_rows=8), dict(max_rows=64),
                                dict(max_rows=16, min_gain=5)])
def test_rotation_equals_jaxs(policy, kw):
    t, j = _port_store(policy), _jax_store(policy)
    try:
        assert (t._order_host() == j._order_host()).all()
        batches = _census(t)
        ids = torch.arange(N)
        before = t[ids].clone()
        got = _rotate(act, t, batches, **kw)
        want = _rotate(jact, j, batches, **kw)
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] is None and want[3] is None
        assert got[1] == want[1] and got[1]
        assert got[0] == want[0] and got[0]["rotated"] == len(got[1][0][0])
        order = t._order_host()
        assert (order == j._order_host()).all()
        assert (order[got[1][0][0]] < t.cache_rows).all()
        assert torch.equal(t[ids], before)
        # a store whose hot set is the rotated one from the start
        rebuilt = _port_store(policy)
        rebuilt.rotate_hot_set(*got[1][0])
        assert torch.equal(rebuilt[ids], t[ids])
    finally:
        j.close()


def test_no_pair_and_cooldown():
    t = _port_store(None)
    clk = [0.0]
    a = act.Actuator(clock=lambda: clk[0], cooldown_s=30.0)
    assert a.maybe_rotate(t) is None
    hot = np.nonzero(t._order_host() < t.cache_rows)[0]
    a.observe_ids(hot, total_rows=N)
    assert a.maybe_rotate(t) is None
    cold = np.nonzero(t._order_host() >= t.cache_rows)[0][:3]
    a.reset_hits()
    a.observe_ids(np.tile(cold, 5), total_rows=N)
    assert a.maybe_rotate(t) is not None and a.hit_census() is None
    a.observe_ids(np.tile(cold, 5), total_rows=N)
    clk[0] = 10.0
    assert a.maybe_rotate(t) is None


def _engine(store):
    torch.manual_seed(3)
    model = GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), dropout=0.0)
    return ServeEngine(model, None, _graph(), store, [SIZES, [2, 1]], CAP,
                       fused_hot_hop=True, fused_row_cap=ROW_CAP,
                       device="cpu")


def test_rotation_through_a_live_engine():
    store = _port_store("int8")
    eng = _engine(store)
    seeds = np.arange(CAP, dtype=np.int32)
    ref = eng.run(seeds, hop_seeds=[11, -7]).clone()
    a = act.Actuator(clock=lambda: 1000.0)
    for b in _census(store):
        a.observe_ids(b, total_rows=N)
    rec = a.maybe_rotate(store, engine=eng, max_rows=8)
    assert rec is not None and rec["rotated"] == 8
    assert torch.equal(eng.run(seeds, hop_seeds=[11, -7]), ref)


def test_server_knobs_and_fleet_floor():
    store = _port_store(None)
    eng = _engine(store)
    srv = MicroBatchServer(eng, ServeConfig(max_wait_ms=2.0))
    sink_recs = []

    class Sink:
        def emit(self, rec, kind=None):
            sink_recs.append((kind, dict(rec)))
            return rec
    try:
        clk = [0.0]
        a = act.Actuator(sink=Sink(), clock=lambda: clk[0]) \
            .attach_server(srv)
        assert a.knobs["batch_cap"].lattice == (1, 2, 4, 8)
        assert a.knobs["max_wait_ms"].lattice == \
            (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
        with pytest.raises(ValueError, match="outside"):
            act.Actuator().attach_server(srv, batch_cap_lattice=(4, 16))
        a.tick([_adv("batch_cap", 4), _adv("max_wait_ms", 0.5)])
        assert srv.knobs()["batch_fill_cap"] == 4
        assert srv.knobs()["max_wait_ms"] == 0.5
        clk[0] = 100.0
        out = a.tick([_adv("max_wait_ms", 0.3)])
        assert out[-1]["action"] == "refuse" and out[-1]["level"] == "WARN"
        assert srv.knobs()["max_wait_ms"] == 0.5
        assert ("actuate", out[-1]) in sink_recs
        fut = srv.submit(3)
        assert fut.result(timeout=30).shape == (OUT,)
        snap = {"replicas": {"a": {"components": {"burn": 2.0}},
                             "b": {"components": {"burn": 2.0}}}}
        rec = a.plan_fleet(srv, snap)
        assert rec["after"]["value"] == srv.knobs()["shed_floor"] == 1
        assert a.plan_fleet(srv, {"replicas": {}}, cooldown_s=60.0) is None
    finally:
        srv.close()


@pytest.mark.parametrize("kw", [dict(max_replicas=3, min_replicas=1),
                                dict(max_replicas=5, min_replicas=2,
                                     burn_up=1.2, queue_up=20.0)])
def test_autoscaler_trajectory_equals_jaxs(kw):
    """``chip_smoke.autoscale_pass`` (the pass phase 16 (b) runs on the
    card) through both packages: the same trajectories, actions and
    records; the first pins ``AUTOSCALE_TRAJECTORY``."""
    from chip_smoke import AUTOSCALE_TRAJECTORY, autoscale_pass
    got = autoscale_pass(act, qf, **kw)
    want = autoscale_pass(jact, jf, **kw)
    assert got == want
    traj = got[0]
    assert max(traj) == kw["max_replicas"] and traj[-1] < max(traj)
    if kw["max_replicas"] == 3:
        assert traj == AUTOSCALE_TRAJECTORY
    with pytest.raises(ValueError):
        act.FleetAutoscaler(None, min_replicas=3, max_replicas=2)
