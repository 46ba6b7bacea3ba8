"""``Feature.rotate_hot_set``, ``ServeEngine.refresh_feature`` and
pickling a ``Feature`` (``quiver_tpu_torch/feature.py``, ``serving.py``)
against the JAX package's (``quiver_tpu/feature.py:823``,
``quiver_tpu/serving.py:504``, ``quiver_tpu/feature.py:1138``), on the
CPU.

The same rotation on the same store gives JAX's ``feature_order`` and
tiers bit for bit (codes and sidecars of an int8 tier), and lookups
give the same bits before and after it. Every refusal raises, as in
JAX. An engine run between the rotation and its refresh serves the
store as it was (its tiers are its own), and after the refresh the same
logits again (the rows did not change). A pickled store looks up the
same rows and keeps its knobs."""

import pickle

import jax
import numpy as np
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu.ops.pallas.fused import _hop_seed
from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, ServeEngine
from quiver_tpu_torch.ops import quant

N, DIM, HIDDEN, OUT = 200, 8, 16, 5
HOT = 60
SIZES, CAP, ROW_CAP = [3, 2], 8, 16


def _graph(n=N, seed=0):
    g = np.random.default_rng(seed)
    deg = g.integers(0, 20, n)
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, n, indptr[-1]).astype(np.int32)
    return indptr, indices


def _table(n=N, seed=1):
    return np.random.default_rng(seed).standard_normal((n, DIM)) \
        .astype(np.float32)


def _hot_bytes(policy):
    if isinstance(policy, dict):
        policy = policy["hot"]
    return HOT * quant.row_bytes(DIM, policy)


def _stores(policy, placement="numpy", **kw):
    indptr, indices = _graph()
    feat = _table()
    j = qv.Feature(device_cache_size=_hot_bytes(policy), dtype_policy=policy,
                   csr_topo=qv.CSRTopo(indptr=indptr, indices=indices), **kw)
    j.from_cpu_tensor(feat)
    t = Feature(device_cache_size=_hot_bytes(policy), dtype_policy=policy,
                csr_topo=CSRTopo(indptr=indptr, indices=indices,
                                 device="cpu"),
                host_placement=placement, device="cpu", **kw) \
        .from_cpu_tensor(feat)
    assert t.cache_rows == j.cache_rows == HOT
    return j, t


def _bits(a):
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().view(np.uint8)
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _leaves(t):
    return list(t) if isinstance(t, tuple) else [t]


def _same_tier(ours, theirs):
    return all(np.array_equal(_bits(a), _bits(b)) for a, b in
               zip(_leaves(ours), _leaves(theirs)))


def _pairs(t, k, seed=0):
    """``k`` cold nodes to promote and ``k`` hot nodes to demote."""
    order = t.feature_order.numpy()
    g = np.random.default_rng(seed)
    cold = np.flatnonzero(order >= t.cache_rows)
    hot = np.flatnonzero(order < t.cache_rows)
    return g.choice(cold, k, replace=False), g.choice(hot, k, replace=False)


def _ids():
    g = np.random.default_rng(5)
    ids = g.integers(0, N, 150).astype(np.int32)
    ids[::7] = -1
    return ids


@pytest.mark.parametrize("policy", [None, "bf16", "int8"])
def test_rotation_equals_jax(policy):
    j, t = _stores(policy)
    ids = _ids()
    before = t.getitem_masked(ids)
    before_plain = t[ids.clip(0)]
    hot_before, order_before = t.device_part, t.feature_order
    promote, demote = _pairs(t, 17)
    # duplicates collapse, as in JAX
    assert t.rotate_hot_set(np.concatenate([promote, promote[:3]]),
                            torch.from_numpy(demote)) == {"rotated": 17}
    assert j.rotate_hot_set(promote, demote) == {"rotated": 17}
    assert np.array_equal(t.feature_order.numpy(),
                          np.asarray(j.feature_order))
    assert _same_tier(t.device_part, j.device_part)
    assert _same_tier(t.host_part, j.host_part)
    # new hot tier and order; the old ones are untouched
    assert t.device_part is not hot_before
    assert t.feature_order is not order_before
    order = t.feature_order.numpy()
    assert (order[promote] < HOT).all() and (order[demote] >= HOT).all()
    assert np.array_equal(_bits(t.getitem_masked(ids)), _bits(before))
    assert np.array_equal(_bits(t[ids.clip(0)]), _bits(before_plain))
    # rotating back restores the stored bits
    t.rotate_hot_set(demote, promote)
    assert np.array_equal(t.feature_order.numpy(), order_before.numpy())
    assert _same_tier(t.device_part, hot_before)
    assert t.rotate_hot_set([], []) == {"rotated": 0}


def test_refusals_match_jax():
    j, t = _stores(None)
    promote, demote = _pairs(t, 3)
    order = t.feature_order.numpy()
    cases = [
        ((promote, demote[:2]), "pair 1:1"),
        ((np.array([-1, 5, 6]), demote), "out of range"),
        ((promote, np.array([1, 2, N])), "out of range"),
        ((demote, promote), "currently be cold"),
        ((promote, np.flatnonzero(order >= HOT)[-3:]), "currently be hot"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            t.rotate_hot_set(*args)
        with pytest.raises(ValueError, match=match):
            j.rotate_hot_set(*args)
    assert np.array_equal(t.feature_order.numpy(), order)   # nothing moved
    for build, match in (
            (lambda: _stores(None, placement="offload")[1], "numpy host"),
            (lambda: _stores({"hot": "bf16", "cold": "int8"})[1],
             "identical hot/cold"),
            (lambda: Feature(device_cache_size=_hot_bytes(None),
                             device="cpu").from_cpu_tensor(_table()),
             "feature_order"),
            (lambda: Feature(device_cache_size=0, csr_topo=CSRTopo(
                indptr=_graph()[0], indices=_graph()[1], device="cpu"),
                device="cpu").from_cpu_tensor(_table()), "hot tier")):
        with pytest.raises(ValueError, match=match):
            build().rotate_hot_set(promote, demote)


def _engine(store, model_seed=0):
    torch.manual_seed(model_seed)
    model = GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), dropout=0.0)
    indptr, indices = _graph()
    return ServeEngine(model, None, (indptr, indices), store, [SIZES], CAP,
                       fused_hot_hop=True, fused_row_cap=ROW_CAP,
                       device="cpu")


@pytest.mark.parametrize("policy", [None, "int8"])
def test_engine_serves_the_old_store_until_refreshed(policy):
    """Between ``rotate_hot_set`` and ``refresh_feature`` the engine's
    tiers are still the pre-rotation ones (its host tier is its own copy
    even on the CPU, where nothing is pinned), so its logits do not
    move; after the refresh they are the same again."""
    _, t = _stores(policy, dedup_cold=True, cold_budget=16)
    eng = _engine(t)
    seeds = np.array([3, 7, 11, 150, 42, 99], np.int32)
    hs = [[int(_hop_seed(jax.random.key(s), i)) for i in range(2)]
          for s in range(3)]
    want = [eng.run(seeds, hop_seeds=h) for h in hs]
    promote, demote = _pairs(t, 25, seed=1)
    t.rotate_hot_set(promote, demote)
    for h, w in zip(hs, want):
        assert torch.equal(eng.run(seeds, hop_seeds=h), w)
    assert eng.refresh_feature() is eng
    assert eng._forder is t.feature_order and eng._feat[0] is t.device_part
    for h, w in zip(hs, want):
        assert torch.equal(eng.run(seeds, hop_seeds=h), w)
    # a fresh engine over the rotated store agrees too
    fresh = _engine(t)
    assert torch.equal(fresh.run(seeds, hop_seeds=hs[0]), want[0])


def test_refresh_refuses_changed_shapes():
    _, t = _stores("int8")
    eng = _engine(t)
    t.device_cache_size = _hot_bytes("int8") + 10 * (DIM + 8)
    t.from_cpu_tensor(_table())
    assert t.cache_rows == HOT + 10
    with pytest.raises(ValueError, match="shape or dtype"):
        eng.refresh_feature()


@pytest.mark.parametrize("policy", [None, "int8"])
@pytest.mark.parametrize("placement", ["numpy", "offload"])
def test_pickle_round_trip(policy, placement):
    """As ``tests/test_feature.py``'s pickling test: the loaded store
    looks up the same rows and keeps its knobs; an offload tier comes
    back pinned (here: plain host memory) and packed again."""
    _, t = _stores(policy, placement=placement, dedup_cold=True,
                   cold_budget=32)
    blob = pickle.dumps(t)
    u = pickle.loads(blob)
    ids = _ids()
    assert np.array_equal(_bits(u.getitem_masked(ids)),
                          _bits(t.getitem_masked(ids)))
    assert np.array_equal(_bits(u[ids.clip(0)]), _bits(t[ids.clip(0)]))
    assert (u.cold_budget, u.dedup_cold, u.dtype_policy) \
        == (32, True, t.dtype_policy)
    assert u.shape == t.shape and u.cache_rows == t.cache_rows
    if placement == "offload":
        assert u.host_part is None and u._host_offload is not None
        assert _same_tier(u._host_offload, t._host_offload)
        if policy == "int8":           # packed again: strided views
            assert u._host_offload.data.stride(0) \
                == quant.packed_stride(DIM)
    else:
        assert _same_tier(u.host_part, t.host_part)
    # pickles without the newer knobs load with their defaults
    state = t.__getstate__()
    for k in ("cold_budget", "dedup_cold", "dtype_policy"):
        state.pop(k)
    v = Feature.__new__(Feature)
    v.__setstate__(state)
    assert (v.cold_budget, v.dedup_cold, v.dtype_policy) \
        == (None, False, {"hot": None, "cold": None})
