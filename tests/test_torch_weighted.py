"""The port's weighted sampling (``quiver_tpu_torch/ops/weighted.py``,
its dispatch in ``ops/sample_multihop.py`` and
``GraphSageSampler(edge_weight=...)``) against the JAX package's
(``quiver_tpu/ops/weighted.py``, ``tests/test_weighted.py``).

The deterministic stage of both draws is held to JAX bit for bit: the
port's ``_pool_draw`` and ``_window_draw`` are fed the uniforms JAX's
``sample_layer_weighted`` and ``sample_layer_weighted_window`` draw from
their key (and, with ``jax.random.uniform`` replaced, uniforms at 0 and
at 1, where ``u * total`` equals ``total`` and the position clamps).
With integer-valued weights the fp32 cumsum is exact on both sides, so
picks, counts and slots must be equal. The draws from a
``torch.Generator`` are held by contract: frequencies follow the
weights (a chi-square test, fixed seed), zero and negative weights are
never drawn, counts are ``min(deg, k)``, and HOST mode gives HBM mode's
samples bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import quiver_tpu as jqv
from quiver_tpu.ops import sample as jsample
from quiver_tpu.ops import weighted as jweighted
from quiver_tpu.ops.sample_multihop import \
    sample_multihop as jsample_multihop
from quiver_tpu_torch import CSRTopo, GraphSageSampler
from quiver_tpu_torch.ops import sample, weighted
from quiver_tpu_torch.ops.sample_multihop import sample_multihop

KEY = jax.random.key(3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def graph():
    """Isolated rows, a zero-mass row, hubs past the 256-wide window and
    past ``row_cap`` 16, integer weights with zeros and negatives."""
    g = np.random.default_rng(0)
    n = 200
    deg = g.integers(0, 30, n)
    deg[[0, 9]] = 0
    deg[[5, 6]] = 300
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = g.integers(0, n, e).astype(np.int32)
    w = g.integers(-2, 5, e).astype(np.float32)
    w[indptr[7]:indptr[8]] = 0.0
    seeds = np.concatenate([np.arange(40), [-1, 5, 6, 7, -1]]) \
        .astype(np.int32)
    return indptr, indices, w, seeds


def _uniforms(case, bs, k, monkeypatch):
    """The uniforms of one draw: JAX's own from ``KEY``, or 0, 1 and
    JAX's fed to JAX through a replaced ``jax.random.uniform``."""
    u = np.asarray(jax.random.uniform(KEY, (bs, k), dtype=jnp.float32))
    if case == "edge":
        u = u.copy()
        u[::3, 0] = 1.0
        u[1::3, -1] = 0.0
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape, dtype: jnp.asarray(u))
    return u


@pytest.mark.parametrize("draws", ["jax", "edge"])
@pytest.mark.parametrize("row_cap", [16, 2048])
def test_pool_draw_equals_jax(graph, row_cap, draws, monkeypatch):
    indptr, indices, w, seeds = graph
    k = 4
    u = _uniforms(draws, seeds.shape[0], k, monkeypatch)
    want = jweighted.sample_layer_weighted(
        jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(w),
        jnp.asarray(seeds), k, KEY, row_cap=row_cap, with_slots=True)
    got = weighted._pool_draw(_t(indptr), _t(indices), _t(w), _t(seeds), k,
                              _t(u), row_cap, True)
    for g, j, name in zip(got, want, ("nbrs", "counts", "slots")):
        _eq(g, j, name)
    assert (got[1][seeds == 7] == 0).all()       # the zero-mass row


@pytest.mark.parametrize("draws", ["jax", "edge"])
@pytest.mark.parametrize("overlap", [True, False])
def test_window_draw_equals_jax(graph, overlap, draws, monkeypatch):
    indptr, indices, w, seeds = graph
    k = 4
    rids = jsample.edge_row_ids(jnp.asarray(indptr), indices.shape[0])
    perm, (wp,) = jsample.reshuffle_csr(jnp.asarray(indices), rids,
                                        jax.random.key(1),
                                        extra=(jnp.asarray(w),))
    as_rows = jsample.as_index_rows_overlapping if overlap \
        else jsample.as_index_rows
    irows, wrows = as_rows(perm), as_rows(wp)
    stride = 128 if overlap else None
    u = _uniforms(draws, seeds.shape[0], k, monkeypatch)
    want = jweighted.sample_layer_weighted_window(
        jnp.asarray(indptr), irows, wrows, jnp.asarray(seeds), k, KEY,
        stride=stride, with_slots=True)
    got = weighted._window_draw(_t(indptr), _t(irows), _t(wrows),
                                _t(seeds), k, _t(u), stride, True)
    for g, j, name in zip(got, want, ("nbrs", "counts", "slots")):
        _eq(g, j, name)


def _window_views(indptr, indices, w, gen, overlap=True):
    rids = sample.edge_row_ids(_t(indptr), indices.shape[0])
    perm, (wp,) = sample.reshuffle_csr(_t(indices), rids, gen,
                                       extra=(_t(w),))
    as_rows = sample.as_index_rows_overlapping if overlap \
        else sample.as_index_rows
    return as_rows(perm), as_rows(wp), (128 if overlap else None)


def _draw(kind, indptr, indices, w, seeds, k, gen, **kw):
    if kind == "pool":
        return weighted.sample_layer_weighted(_t(indptr), _t(indices), _t(w),
                                              _t(seeds), k, gen, **kw)
    irows, wrows, stride = _window_views(indptr, indices, w, gen)
    return weighted.sample_layer_weighted_window(
        _t(indptr), irows, wrows, _t(seeds), k, gen, stride=stride, **kw)


@pytest.mark.parametrize("kind", ["pool", "window"])
def test_frequencies_follow_weights(kind):
    """One row, weights 1..4 and two zero/negative entries: 4096 x 2
    draws, chi-square against ``w / sum(w)`` at a fixed seed."""
    indptr = np.array([0, 6])
    indices = np.arange(6, dtype=np.int32)
    w = np.array([1.0, 0.0, 2.0, -3.0, 3.0, 4.0], np.float32)
    nbrs, counts = _draw(kind, indptr, indices, w,
                         np.zeros(4096, np.int32), 2, _gen(11))
    assert (counts == 2).all()
    hits = np.bincount(nbrs.numpy().ravel(), minlength=6)
    assert hits[1] == hits[3] == 0           # zero and negative mass
    live = [0, 2, 4, 5]
    p = stats.chisquare(hits[live], hits.sum() * w[live] / w[live].sum())
    assert p.pvalue > 1e-3, (hits, p)


@pytest.mark.parametrize("kind", ["pool", "window"])
def test_zero_weight_edges_never_sampled(graph, kind):
    """Over every row of the graph (hubs included), no pick lands on a
    slot of weight <= 0, and a row keeps ``min(deg, k)`` picks unless
    its mass is 0."""
    indptr, indices, w, seeds = graph
    k = 5
    gen = _gen(4)
    if kind == "pool":
        out = weighted.sample_layer_weighted(
            _t(indptr), _t(indices), _t(w), _t(seeds), k, gen,
            with_slots=True)
        flat_w = w
    else:
        rids = sample.edge_row_ids(_t(indptr), indices.shape[0])
        perm, (wp,), smap = sample.reshuffle_csr(
            _t(indices), rids, gen, with_slot_map=True, extra=(_t(w),))
        out = weighted.sample_layer_weighted_window(
            _t(indptr), sample.as_index_rows(perm),
            sample.as_index_rows(wp), _t(seeds), k, gen, with_slots=True)
        flat_w = wp.numpy()
        _eq(w[smap.numpy()], flat_w, "co-shuffled weights")
    nbrs, counts, slots = (o.numpy() for o in out)
    m = slots >= 0
    assert (flat_w[slots[m]] > 0).all()
    _eq(nbrs >= 0, m, "mask")
    deg = np.where(seeds >= 0, np.diff(indptr)[np.maximum(seeds, 0)], 0)
    mass = np.array([np.clip(w[indptr[s]:indptr[s + 1]], 0, None).sum()
                     if s >= 0 else 0 for s in seeds])
    assert (counts[mass == 0] == 0).all()
    if kind == "pool":        # the window may hold no mass of a hub
        _eq(counts[mass > 0], np.minimum(deg, k)[mass > 0], "counts")


def test_csr_weights_from_eid_matches_jax():
    g = np.random.default_rng(5)
    coo = g.integers(0, 30, (2, 200))
    topo = CSRTopo(edge_index=coo, node_count=30, device="cpu")
    jtopo = jqv.CSRTopo(edge_index=coo, node_count=30)
    coo_w = g.random(200).astype(np.float32)
    got = weighted.csr_weights_from_eid(topo.eid, coo_w)
    _eq(got, jweighted.csr_weights_from_eid(jnp.asarray(jtopo.eid),
                                            jnp.asarray(coo_w)))
    _eq(got, coo_w[np.argsort(coo[0], kind="stable")])


def test_weight_rows_must_mirror_indices_rows(graph):
    indptr, indices, w, seeds = graph
    irows = jsample.as_index_rows(jnp.asarray(indices))
    wrows = jsample.as_index_rows_overlapping(jnp.asarray(w))
    with pytest.raises(ValueError) as want:
        jweighted.sample_layer_weighted_window(
            jnp.asarray(indptr), irows, wrows, jnp.asarray(seeds), 2, KEY)
    with pytest.raises(ValueError) as got:
        weighted.sample_layer_weighted_window(
            _t(indptr), _t(irows), _t(wrows), _t(seeds), 2, _gen(0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method", ["exact", "rotation", "window"])
def test_multihop_routes_weighted_draws(graph, method):
    """``sample_multihop(edge_weight=...)``: a hop draws what the weighted
    sampler it routes to draws from the same generator state (the pool
    draw for exact, the windowed draw with ``weight_rows``), every edge
    is a graph edge of positive weight, and ``eid=True`` stamps its CSR
    (or permuted) slot; then JAX's wiring test's checks on two hops."""
    indptr, indices, w, seeds = graph
    seeds = seeds[seeds >= 0][:16]
    ip, ix, wt = _t(indptr), _t(indices), _t(w)
    kw, rows = {}, None
    flat_ix, flat_w = indices, w
    if method != "exact":
        rows, wrows, stride = _window_views(indptr, indices, w, _gen(9))
        kw = dict(method=method, indices_rows=rows, weight_rows=wrows,
                  indices_stride=stride)
        flat_ix = rows[:, :128].reshape(-1).numpy()
        flat_w = wrows[:, :128].reshape(-1).numpy()
    gen = _gen(2)
    state = gen.get_state()
    _, layers = sample_multihop(ip, ix, _t(seeds), [4], gen,
                                edge_weight=wt, eid=True, **kw)
    gen.set_state(state)
    if method == "exact":
        nbrs, _, slots = weighted.sample_layer_weighted(
            ip, ix, wt, _t(seeds), 4, gen, with_slots=True)
    else:
        nbrs, _, slots = weighted.sample_layer_weighted_window(
            ip, rows, kw["weight_rows"], _t(seeds), 4, gen,
            stride=kw["indices_stride"], with_slots=True)
    lay = layers[0]
    _eq(lay.e_id, slots.reshape(-1), "slots")
    _eq(lay.n_id[lay.col.long().clamp(min=0)][lay.col >= 0],
        nbrs.reshape(-1)[nbrs.reshape(-1) >= 0], "picks")
    m = lay.e_id >= 0
    _eq(flat_ix[lay.e_id[m].numpy()], lay.n_id[lay.col[m].long()], "ids")
    assert (flat_w[lay.e_id[m].numpy()] > 0).all()

    _, layers = sample_multihop(ip, ix, _t(seeds), [4, 3], _gen(3),
                                edge_weight=wt, **kw)
    nsets = [set(indices[indptr[v]:indptr[v + 1]].tolist())
             for v in range(len(indptr) - 1)]
    for lay in layers:
        row, col, lnid = lay.row.numpy(), lay.col.numpy(), lay.n_id.numpy()
        for r, c in zip(row[col >= 0], col[col >= 0]):
            assert lnid[c] in nsets[lnid[r]]
    if method != "exact":
        args = (jnp.asarray(indptr), jnp.asarray(indices),
                jnp.asarray(seeds), [4, 3], KEY)
        with pytest.raises(ValueError, match="same shuffle") as want:
            jsample_multihop(*args, edge_weight=jnp.asarray(w),
                             method=method,
                             weight_rows=jnp.asarray(kw["weight_rows"]),
                             indices_stride=kw["indices_stride"])
        with pytest.raises(ValueError) as got:
            sample_multihop(ip, ix, _t(seeds), [4, 3], _gen(3),
                            edge_weight=wt, method=method,
                            weight_rows=kw["weight_rows"],
                            indices_stride=kw["indices_stride"])
        assert str(got.value) == str(want.value)


# -- GraphSageSampler(edge_weight=...) ----------------------------------------

SAMPLERS = [dict(sampling="exact"), dict(sampling="rotation"),
            dict(sampling="rotation", layout="overlap"),
            dict(sampling="window", layout="overlap")]
SAMPLER_IDS = ["exact", "rot-pair", "rot-overlap", "win-overlap"]


def _coo_graph(n=120, e=900):
    g = np.random.default_rng(4)
    coo = g.integers(0, n, (2, e))
    w = g.integers(0, 4, e).astype(np.float32)     # a quarter zero
    return coo, w, CSRTopo(edge_index=coo, node_count=n, device="cpu")


@pytest.mark.parametrize("kw", SAMPLERS, ids=SAMPLER_IDS)
def test_sampler_weighted_end_to_end(kw):
    """HOST equal to HBM bit for bit over three epochs, shapes equal to
    the JAX sampler's, every edge id a COO edge of positive weight whose
    ends are the edge's (the weights ride the reshuffles)."""
    coo, w_coo, topo = _coo_graph()
    w = weighted.csr_weights_from_eid(topo.eid, w_coo)
    seeds = np.random.default_rng(5).choice(120, 16, replace=False)
    hbm, host = (GraphSageSampler(topo, [4, 3], device="cpu", mode=mode,
                                  edge_weight=w, with_eid=True, seed=2, **kw)
                 for mode in ("HBM", "HOST"))
    jtopo = jqv.CSRTopo(edge_index=coo, node_count=120)
    jn, _, jadjs = jqv.GraphSageSampler(
        jtopo, [4, 3], edge_weight=np.asarray(w), **kw).sample(seeds)
    for epoch in range(3):
        a, b = hbm.sample(seeds), host.sample(seeds)
        assert torch.equal(a[0], b[0]) and a[1] == b[1] == 16
        assert a[0].shape == jn.shape
        for x, y, j in zip(a[2], b[2], jadjs):
            assert torch.equal(x.edge_index, y.edge_index)
            assert torch.equal(x.e_id, y.e_id) and x.size == j.size
        n_id = a[0].numpy()
        for adj in a[2]:
            m = adj.mask.numpy()
            eid = adj.e_id.numpy()[m]
            src, dst = adj.edge_index.numpy()[:, m]
            _eq(coo[0, eid], n_id[dst], "targets")
            _eq(coo[1, eid], n_id[src], "sources")
            assert (w_coo[eid] > 0).all()
        if kw["sampling"] != "exact":
            hbm.reshuffle()
            host.reshuffle()
    assert hbm._exact_rows is None and hbm._exact_hub_frac() is None


def test_sampler_weighted_host_buffers_and_ipc():
    """HOST mode places the weights once and refills the weight rows'
    buffer in place on every reshuffle; the IPC handle carries the
    weights."""
    _, w_coo, topo = _coo_graph()
    w = weighted.csr_weights_from_eid(topo.eid, w_coo)
    s = GraphSageSampler(topo, [3], device="cpu", mode="HOST",
                         sampling="rotation", edge_weight=w)
    s.sample(np.arange(8))
    placed, rows, wrows = s._weight_placed, s._rot, s._rot_w
    before = wrows.clone()
    s.reshuffle()
    assert s._weight_placed is placed and s._rot is rows
    assert s._rot_w is wrows and not torch.equal(before, wrows)
    assert s._weight_placed.dtype == torch.float32
    t = GraphSageSampler.lazy_from_ipc_handle(s.share_ipc())
    assert t.edge_weight is s.edge_weight and t.sampling == "rotation"
    assert t.sample(np.arange(8))[1] == 8


@pytest.mark.parametrize("sampling", ["rotation", "window"])
def test_sampler_weighted_butterfly_refused(sampling):
    coo = np.random.default_rng(1).integers(0, 50, (2, 300))
    w = np.ones(300, np.float32)
    jtopo = jqv.CSRTopo(edge_index=coo, node_count=50)
    with pytest.raises(ValueError, match="butterfly") as want:
        jqv.GraphSageSampler(jtopo, [4], edge_weight=w, sampling=sampling,
                             shuffle="butterfly")
    with pytest.raises(ValueError) as got:
        GraphSageSampler(CSRTopo(edge_index=coo, node_count=50,
                                 device="cpu"), [4], device="cpu",
                         edge_weight=w, sampling=sampling,
                         shuffle="butterfly")
    assert str(got.value) == str(want.value)
