"""The port's sampling variants (``quiver_tpu_torch/ops/sample.py``,
``ops/sample_multihop.py``) against the JAX package's
(``quiver_tpu/ops/sample.py``, ``ops/sample_multihop.py``).

Every deterministic stage is held to JAX bit for bit on the same numpy
inputs: the row ids, the rows views at widths 128 and 8, the bucket
split and its hub budget, the slot-map composition, the window layout's
errors, the window gather and column extraction (JAX's CPU form), the
union compaction; the probabilities within 1e-5 (``scatter_reduce``
multiplies in another order than ``segment_prod``). The samplers draw
from a ``torch.Generator``, whose stream JAX does not have, so they are
held by contract: membership, ``counts == min(deg, k)``, distinct picks,
rotation's consecutive runs, window picks inside their window, and a
seeded chi-square test of uniformity each. Inside the port the
wide-exact sampler equals ``sample_layer`` bit for bit for the same
generator state, in both layouts and with or without budget overflow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from quiver_tpu.ops import sample as jsample
from quiver_tpu.ops.sample_multihop import \
    sample_multihop as jsample_multihop
from quiver_tpu.utils import csr as jcsr
from quiver_tpu_torch.ops import sample
from quiver_tpu_torch.ops.random_walk import random_walk, random_walk_step
from quiver_tpu_torch.ops.sample_multihop import (sample_multihop,
                                                  sample_multihop_dedup)
from quiver_tpu_torch.pyg import GraphSageSampler
from quiver_tpu_torch.utils import CSRTopo

KEY = jax.random.key(7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def random_graph(seed=0, n=400, hubs=(7, 8), hub_deg=300):
    """A CSR with isolated rows (at the start, inside, at the end), hub
    rows above the 256-wide window and small rows."""
    g = np.random.default_rng(seed)
    deg = g.integers(0, 30, n)
    deg[[0, 1, 50, n - 1]] = 0
    deg[list(hubs)] = hub_deg
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = g.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def boundary_graph():
    """Nodes 0 and 1 share degree 250 but not window alignment (start 0
    vs 250: 0 fits its window, 1 is a hub); node 2 is small, node 3 a hub
    by degree; their neighbours are zero-degree tail nodes."""
    degs = [250, 250, 10, 400]
    indptr = np.zeros(4800 + 1, np.int64)
    np.cumsum(degs, out=indptr[1:5])
    indptr[5:] = indptr[4]
    indices = np.concatenate([1000 + np.arange(250), 2000 + np.arange(250),
                              3000 + np.arange(10),
                              4000 + np.arange(400)]).astype(np.int32)
    return indptr, indices


@pytest.fixture(scope="module")
def graph():
    return random_graph()


# -- deterministic pieces against JAX -----------------------------------------

def test_row_ids_exact(graph):
    indptr, indices = graph
    e = indices.shape[0]
    for ip in (indptr, indptr.astype(np.int32)):
        _eq(sample.edge_row_ids(_t(ip), e),
            jsample.edge_row_ids(jnp.asarray(ip), e), "edge_row_ids")
        _eq(sample.edge_rows(_t(ip), e),
            jsample.edge_rows(jnp.asarray(ip), e), "edge_rows")
    assert sample.edge_row_ids(_t(indptr), e).dtype == torch.int32
    assert sample.edge_rows(_t(indptr), e).dtype == torch.int32
    assert sample.edge_row_ids(torch.zeros(3, dtype=torch.int64),
                               0).shape == (0,)


@pytest.mark.parametrize("width", [128, 8])
@pytest.mark.parametrize("e", [0, 1, 127, 128, 1000])
def test_rows_views_exact(width, e):
    flat = np.random.default_rng(e).integers(0, 99, e).astype(np.int32)
    pair = sample.as_index_rows(_t(flat), width=width)
    over = sample.as_index_rows_overlapping(_t(flat), width=width)
    _eq(pair, jsample.as_index_rows(jnp.asarray(flat), width=width), "pair")
    _eq(over, jsample.as_index_rows_overlapping(jnp.asarray(flat),
                                                width=width), "overlap")
    # the padding formula keeps row r0 + 1 for every window in row r0
    assert pair.shape[0] == (e + 2 * width - 1) // width + 1
    _eq(GraphSageSampler._rows_np(flat, width), pair, "_rows_np pair")
    _eq(GraphSageSampler._rows_np(flat, width, overlap=True), over,
        "_rows_np overlap")


def test_bucket_meta_exact():
    for indptr in (boundary_graph()[0], random_graph(3)[0],
                   np.array([0, 250, 500, 510, 910], np.int64)):
        got = sample.exact_bucket_meta(_t(indptr))
        want = jsample.exact_bucket_meta(jnp.asarray(indptr))
        assert tuple(got) == tuple(want)
        assert tuple(sample.exact_bucket_meta(indptr, step=8)) == \
            tuple(jsample.exact_bucket_meta(indptr, step=8))
    meta = sample.exact_bucket_meta(np.array([0, 250, 500, 510, 910]))
    assert meta.node_frac == 2 / 4 and meta.frac == meta.edge_frac


def test_csr_topo_caches_bucket_meta():
    indptr, indices = boundary_graph()
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    a = topo.exact_bucket_meta()
    assert topo.exact_bucket_meta() is a
    assert topo.exact_bucket_meta(step=64) is not a
    jtopo = jcsr.CSRTopo(indptr=indptr, indices=indices)
    assert tuple(a) == tuple(jtopo.exact_bucket_meta())
    assert tuple(topo.exact_bucket_meta(step=64)) == \
        tuple(jtopo.exact_bucket_meta(step=64))


@pytest.mark.parametrize("bs,frac", [(1024, None), (1024, 0.1), (1024, 1.0),
                                     (8, 0.01), (180224, 0.037),
                                     (1, 0.5), (16384, 0.0)])
def test_suggest_hub_cap_exact(bs, frac):
    assert sample.suggest_hub_cap(bs, frac) == \
        jsample.suggest_hub_cap(bs, frac)


@pytest.mark.parametrize("bfly", [False, True])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("with_base", [False, True])
def test_compose_slot_map_exact(bfly, with_prev, with_base):
    g = np.random.default_rng(5)
    e = 50
    smap = g.permutation(e).astype(np.int32)
    prev = g.permutation(e).astype(np.int32) if with_prev else None
    base = g.permutation(e).astype(np.int64) if with_base else None
    got = sample.compose_slot_map(None if prev is None else _t(prev),
                                  _t(smap), None if base is None
                                  else _t(base), bfly)
    want = jsample.compose_slot_map(
        None if prev is None else jnp.asarray(prev), jnp.asarray(smap),
        base, bfly)
    _eq(got, want)


@pytest.mark.parametrize("width,stride,k", [
    (128, None, 129), (128, 32, 3), (256, 128, 130), (8, None, 9),
    (16, 8, 10)])
def test_window_layout_errors_match(width, stride, k):
    rows = np.zeros((4, width), np.int32)
    with pytest.raises(ValueError) as got:
        sample._window_layout(_t(rows), stride, k)
    with pytest.raises(ValueError) as want:
        jsample._window_layout(jnp.asarray(rows), stride, k)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("width,stride,k", [(128, None, 128),
                                            (256, 128, 129), (8, None, 5),
                                            (16, 8, 9)])
def test_window_layout_steps_match(width, stride, k):
    rows = np.zeros((4, width), np.int32)
    assert sample._window_layout(_t(rows), stride, k) == \
        jsample._window_layout(jnp.asarray(rows), stride, k)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("width", [128, 8])
def test_gather_window_and_extract_exact(overlap, width):
    g = np.random.default_rng(width)
    flat = g.integers(0, 1000, 2000).astype(np.int32)
    build = (jsample.as_index_rows_overlapping if overlap
             else jsample.as_index_rows)
    jrows = build(jnp.asarray(flat), width=width)
    rows = _t(np.asarray(jrows))
    stride = width if overlap else None
    p0 = g.integers(0, flat.shape[0], 300).astype(np.int64)
    w, r0, off = sample._gather_window(rows, _t(p0), width, stride,
                                       torch.ones(300, dtype=torch.bool))
    jw, jr0, joff = jsample._gather_window(jrows, jnp.asarray(p0), width,
                                           stride)
    for a, b, name in ((w, jw, "window"), (r0, jr0, "r0"),
                       (off, joff, "off")):
        _eq(a, b, name)
    k = 6
    pos = g.integers(-3, w.shape[1] + 3, (300, k)).astype(np.int32)
    got = sample._extract_window_cols(w, _t(pos), k)
    with jax.default_device(jax.devices("cpu")[0]):
        assert jsample._scatter_friendly()      # JAX's gather form
        want = jsample._extract_window_cols(jnp.asarray(np.asarray(jw)),
                                            jnp.asarray(pos), k)
    _eq(got, want, "extract")
    assert got.dtype == torch.int32


def test_compact_union_exact():
    g = np.random.default_rng(2)
    prefix = g.choice(60, 20, replace=False).astype(np.int32)
    prefix[[3, 11]] = -1
    extra = g.integers(-1, 80, 45).astype(np.int32)
    got = sample.compact_union(_t(prefix), _t(extra))
    want = jsample.compact_union(jnp.asarray(prefix), jnp.asarray(extra))
    for a, b, name in zip(got, want, ("n_id", "n_count", "local")):
        _eq(a, b, name)


def test_sample_prob_within_1e5(graph):
    indptr, indices = graph
    n = indptr.shape[0] - 1
    train = np.random.default_rng(4).choice(n, 40, replace=False)
    got = sample.sample_prob(_t(indptr), _t(indices), _t(train), [5, 3, 2],
                             n)
    want = jsample.sample_prob(jnp.asarray(indptr), jnp.asarray(indices),
                               jnp.asarray(train), [5, 3, 2], n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    last = np.random.default_rng(6).random(n).astype(np.float32)
    for rows in (None, sample.edge_rows(_t(indptr), indices.shape[0])):
        step = sample.sample_prob_step(_t(indptr), _t(indices), _t(last), 4,
                                       row_ids=rows)
        jstep = jsample.sample_prob_step(jnp.asarray(indptr),
                                         jnp.asarray(indices),
                                         jnp.asarray(last), 4)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                                   atol=1e-5, rtol=0)
    assert got.dtype == torch.float32 and (got[np.diff(indptr) == 0] == 0
                                           ).all()


# -- the wide-exact sampler is sample_layer's draw, bit for bit ---------------

def _seeds_with_hubs(n, bs, hubs, g):
    seeds = g.choice(n, bs, replace=False).astype(np.int32)
    seeds[:len(hubs)] = hubs
    seeds[5::17] = -1
    return seeds


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("hub_cap", [None, 1, "tight", "short"])
@pytest.mark.parametrize("k", [3, 10])
def test_exact_wide_equals_sample_layer(graph, overlap, hub_cap, k):
    indptr, indices = graph
    g = np.random.default_rng(k)
    n = indptr.shape[0] - 1
    seeds = _seeds_with_hubs(n, 90, [7, 8, 0], g)
    seeds = np.unique(seeds[seeds >= 0])
    seeds = np.concatenate([seeds, [-1, -1]]).astype(np.int32)
    ix = _t(indices)
    rows = (sample.as_index_rows_overlapping(ix) if overlap
            else sample.as_index_rows(ix))
    stride = 128 if overlap else None
    deg = np.where(seeds >= 0, np.diff(indptr)[seeds], 0)
    start = np.where(seeds >= 0, indptr[np.clip(seeds, 0, None)], 0)
    n_hub = int(((deg > 256 - start % 128) & (deg > 0)).sum())
    assert n_hub >= 2
    cap = {"tight": n_hub, "short": n_hub - 1}.get(hub_cap, hub_cap)
    for seed in range(3):
        want = sample.sample_layer(_t(indptr), ix, _t(seeds), k, _gen(seed),
                                   with_slots=True)
        got = sample.sample_layer_exact_wide(
            _t(indptr), ix, rows, _t(seeds), k, _gen(seed), stride=stride,
            hub_cap=cap, with_slots=True)
        for a, b, name in zip(got, want, ("nbrs", "counts", "slots")):
            assert torch.equal(a, b), (name, hub_cap, overlap)


def test_exact_wide_tiny_budget_all_hubs():
    """Every seed a hub and a budget of 1: the overflow read still gives
    the exact draw."""
    indptr, indices = boundary_graph()
    ix = _t(indices)
    seeds = _t(np.array([1, 3, 1, 3][:2] + [-1], np.int32))
    rows = sample.as_index_rows(ix)
    nbrs, counts = sample.sample_layer_exact_wide(
        _t(indptr), ix, rows, seeds, 5, _gen(0), hub_cap=1)
    want = sample.sample_layer(_t(indptr), ix, seeds, 5, _gen(0))
    assert torch.equal(nbrs, want[0]) and counts.tolist() == [5, 5, 0]


# -- the windowed samplers and reshuffles by contract -------------------------

def _check_picks(indptr, flat, seeds, k, nbrs, counts, slots):
    """Membership, counts == min(deg, k), distinct slots inside each
    seed's segment, the pick equal to the flat array at its slot."""
    nbrs, counts, slots = nbrs.numpy(), counts.numpy(), slots.numpy()
    deg = np.where(seeds >= 0, np.diff(indptr)[np.clip(seeds, 0, None)], 0)
    _eq(counts, np.minimum(deg, k), "counts")
    for r, s in enumerate(seeds):
        c = counts[r]
        assert (nbrs[r, c:] == -1).all() and (slots[r, c:] == -1).all()
        if c == 0:
            continue
        sl = slots[r, :c]
        assert len(set(sl.tolist())) == c
        assert (sl >= indptr[s]).all() and (sl < indptr[s + 1]).all()
        _eq(nbrs[r, :c], flat[sl], "membership")
    return slots


def _shuffled(indptr, indices, seed, method="sort"):
    rids = sample.edge_row_ids(_t(indptr), indices.shape[0])
    return sample.reshuffle_csr(_t(indices), rids, _gen(seed), method=method)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("k", [1, 4, 30])
def test_rotation_contract(graph, overlap, k):
    indptr, indices = graph
    n = indptr.shape[0] - 1
    seeds = _seeds_with_hubs(n, 120, [7, 8], np.random.default_rng(k))
    permuted = _shuffled(indptr, indices, k)
    rows = (sample.as_index_rows_overlapping(permuted) if overlap
            else sample.as_index_rows(permuted))
    nbrs, counts, slots = sample.sample_layer_rotation(
        _t(indptr), rows, _t(seeds), k, _gen(k), with_slots=True,
        stride=128 if overlap else None)
    slots = _check_picks(indptr, permuted.numpy(), seeds, k, nbrs, counts,
                         slots)
    for r, c in enumerate(counts.tolist()):
        if c:      # a consecutive run of the shuffled row
            _eq(slots[r, :c], slots[r, 0] + np.arange(c), "run")


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("k", [1, 4, 30])
def test_window_contract(graph, overlap, k):
    indptr, indices = graph
    n = indptr.shape[0] - 1
    seeds = _seeds_with_hubs(n, 120, [7, 8], np.random.default_rng(k + 1))
    permuted = _shuffled(indptr, indices, k, "butterfly")
    rows = (sample.as_index_rows_overlapping(permuted) if overlap
            else sample.as_index_rows(permuted))
    nbrs, counts, slots = sample.sample_layer_window(
        _t(indptr), rows, _t(seeds), k, _gen(k), with_slots=True,
        stride=128 if overlap else None)
    slots = _check_picks(indptr, permuted.numpy(), seeds, k, nbrs, counts,
                         slots)
    for r, c in enumerate(counts.tolist()):
        if c:      # inside one window of 2 * 128 positions
            sl = slots[r, :c]
            assert sl.max() // 128 - sl.min() // 128 <= 1


def test_permute_csr_contract(graph):
    indptr, indices = graph
    e = indices.shape[0]
    rids = sample.edge_row_ids(_t(indptr), e)
    extra = _t(np.arange(e, dtype=np.float32) * 0.5)
    out, (ex,), smap = sample.permute_csr(_t(indices), rids, _gen(1),
                                          with_slot_map=True, extra=(extra,))
    assert smap.dtype == torch.int32
    _eq(out, indices[smap.numpy()], "out == input[smap]")
    _eq(ex, extra.numpy()[smap.numpy()], "extras co-permuted")
    _eq(rids[smap.long()], rids, "slots stay in their row")
    assert sorted(smap.tolist()) == list(range(e))
    assert not torch.equal(out, _t(indices))
    for v in range(indptr.shape[0] - 1):
        a, b = indptr[v], indptr[v + 1]
        assert sorted(out[a:b].tolist()) == sorted(indices[a:b].tolist())
    # the same generator state gives the same order; the forms agree
    again = sample.permute_csr(_t(indices), rids, _gen(1))
    assert torch.equal(again, out)
    assert torch.equal(sample.reshuffle_csr(_t(indices), rids, _gen(1)),
                       out)


def test_butterfly_contract_and_composition(graph):
    indptr, indices = graph
    e = indices.shape[0]
    rids = sample.edge_row_ids(_t(indptr), e)
    base = _t(np.random.default_rng(0).permutation(e).astype(np.int64))
    extra = _t(np.arange(e, dtype=np.float32))
    gen = _gen(2)
    src, running, running_base, ex_src = _t(indices), None, None, extra
    for _ in range(2):
        out, (ex,), smap = sample.butterfly_shuffle(
            src, rids, gen, with_slot_map=True, extra=(ex_src,))
        _eq(out, src.numpy()[smap.numpy()], "out == input[smap]")
        _eq(ex, ex_src.numpy()[smap.numpy()], "extras ride the swaps")
        _eq(rids[smap.long()], rids, "swaps stay inside a row")
        assert (smap != torch.arange(e)).any()
        running = sample.compose_slot_map(running, smap, None, True)
        running_base = sample.compose_slot_map(running_base, smap, base,
                                               True)
        # composed over the epochs, the maps name the original slots
        _eq(out, indices[running.numpy()], "composed map")
        _eq(running_base, base.numpy()[running.numpy()], "composed eid")
        _eq(ex, extra.numpy()[running.numpy()], "composed extras")
        src, ex_src = out, ex
    assert sample.reshuffle_csr(_t(indices), rids, _gen(3),
                                method="butterfly").shape == (e,)
    with pytest.raises(ValueError, match="reshuffle method"):
        sample.reshuffle_csr(_t(indices), rids, _gen(3), method="riffle")


# -- uniformity (seeded chi-square) -------------------------------------------

def _chi2_ok(counts):
    return stats.chisquare(counts).pvalue > 1e-3


def _hits(indptr, rows_fn, sampler, seeds, k, epochs, positions):
    """Per position of each probe row, how often it was picked over
    ``epochs`` draws (a reshuffle each when ``rows_fn`` takes one)."""
    hits = np.zeros(positions)
    for t in range(epochs):
        flat, rows = rows_fn(t)
        nbrs = sampler(rows, flat, t)[0].numpy().ravel()
        np.add.at(hits, nbrs[nbrs >= 0], 1)
    return hits


@pytest.mark.parametrize("method", ["rotation", "window", "exact_wide"])
def test_samplers_uniform(method):
    # the neighbours of each probe row are its own positions (ids 0..)
    degs = [300, 40, 250, 250]
    indptr = np.zeros(5, np.int64)
    np.cumsum(degs, out=indptr[1:])
    indices = np.concatenate([np.arange(d) + o for d, o in
                              zip(degs, [0, 300, 340, 590])]).astype(np.int32)
    ip = _t(indptr)
    rids = sample.edge_row_ids(ip, indices.shape[0])
    reps, k = 64, 4
    seeds = _t(np.repeat(np.arange(4), reps).astype(np.int32))

    def rows_fn(t):
        if method == "exact_wide":
            return _t(indices), sample.as_index_rows(_t(indices))
        flat = sample.permute_csr(_t(indices), rids, _gen(100 + t))
        return flat, sample.as_index_rows_overlapping(flat)

    def draw(rows, flat, t):
        if method == "rotation":
            return sample.sample_layer_rotation(ip, rows, seeds, k, _gen(t),
                                                stride=128)
        if method == "window":
            return sample.sample_layer_window(ip, rows, seeds, k, _gen(t),
                                              stride=128)
        return sample.sample_layer_exact_wide(ip, flat, rows, seeds, k,
                                              _gen(t), hub_cap=70)

    hits = _hits(indptr, rows_fn, draw, seeds, k, 40, 840)
    for v, d in enumerate(degs):
        a = int(indptr[v])
        counts = hits[a:a + d]
        assert counts.sum() == 40 * reps * k
        assert _chi2_ok(counts), (method, v)


# -- sample_multihop's knobs --------------------------------------------------

def test_multihop_exact_wide_eid_slots_and_map():
    indptr, indices = boundary_graph()
    ip, ix = _t(indptr), _t(indices)
    rows = sample.as_index_rows(ix)
    seeds = _t(np.arange(4, dtype=np.int32))
    frac = sample.exact_bucket_meta(indptr).frac
    _, layers = sample_multihop(ip, ix, seeds, [4, 3], _gen(0),
                                indices_rows=rows, eid=True, hub_frac=frac)
    for lay in layers:
        nid, row, col, e_id = (getattr(lay, f).numpy() for f in
                               ("n_id", "row", "col", "e_id"))
        m = col >= 0
        assert (e_id[m] >= 0).all() and (e_id[~m] == -1).all()
        for r, c, s in zip(row[m], col[m], e_id[m]):
            assert indptr[nid[r]] <= s < indptr[nid[r] + 1]
            assert indices[s] == nid[c]
    perm = np.random.default_rng(3).permutation(len(indices))
    _, layers_map = sample_multihop(ip, ix, seeds, [4, 3], _gen(0),
                                    indices_rows=rows,
                                    eid=_t(perm.astype(np.int32)),
                                    hub_frac=frac)
    for lay, lay_m in zip(layers, layers_map):
        s, sm = lay.e_id.numpy(), lay_m.e_id.numpy()
        m = s >= 0
        _eq(sm[m], perm[s[m]])
        _eq(sm[~m], -1)
    # the wide read is the exact draw: the same layers as the scattered one
    _, plain = sample_multihop(ip, ix, seeds, [4, 3], _gen(0), eid=True)
    for a, b in zip(layers, plain):
        for f in ("n_id", "row", "col", "e_id"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("method", ["rotation", "window"])
def test_multihop_windowed_with_rows_and_eid(graph, method):
    indptr, indices = graph
    e = indices.shape[0]
    ip = _t(indptr)
    rids = sample.edge_row_ids(ip, e)
    permuted, smap = sample.permute_csr(_t(indices), rids, _gen(4),
                                        with_slot_map=True)
    eid = _t(np.random.default_rng(1).permutation(e).astype(np.int64))
    seeds = _t(np.arange(9, 41, dtype=np.int32))
    _, layers = sample_multihop(
        ip, permuted, seeds, [5, 3], _gen(5), method=method,
        indices_rows=sample.as_index_rows_overlapping(permuted),
        indices_stride=128, eid=eid[smap.long()], seeds_dense=True)
    for lay in layers:
        nid, row, col, e_id = (getattr(lay, f).numpy() for f in
                               ("n_id", "row", "col", "e_id"))
        m = col >= 0
        assert m.any() and (e_id[~m] == -1).all()
        # the map names the original slot, whose entry is the neighbour
        orig = np.argsort(eid.numpy())[e_id[m]]
        _eq(indices[orig], nid[col[m]], "neighbour at the original slot")
        assert ((orig >= indptr[nid[row[m]]])
                & (orig < indptr[nid[row[m]] + 1])).all()


@pytest.mark.parametrize("method", ["rotation", "window"])
@pytest.mark.parametrize("with_eid", [False, True])
def test_multihop_fallback_shuffles_after_the_hops_draws(graph, method,
                                                         with_eid):
    """Without ``indices_rows`` one ``permute_csr`` runs, drawn from the
    generator after the hops' draws: the same layers as the explicit
    call whose rows come from that state, and the generator left where
    the explicit sequence leaves it."""
    indptr, indices = graph
    ip, ix = _t(indptr), _t(indices)
    rids = sample.edge_row_ids(ip, ix.shape[0])
    seeds = _t(np.arange(20, 36, dtype=np.int32))
    sizes = [4, 3]
    eid = True if with_eid else None
    gen = _gen(9)
    _, got = sample_multihop(ip, ix, seeds, sizes, gen, method=method,
                             eid=eid)
    ref = _gen(9)
    s0 = ref.get_state()
    sample_multihop(ip, ix, seeds, sizes, ref, method=method,
                    indices_rows=sample.as_index_rows(ix))
    out = sample.permute_csr(ix, rids, ref, with_slot_map=with_eid)
    permuted, smap = out if with_eid else (out, None)
    after = ref.get_state()
    ref.set_state(s0)
    _, want = sample_multihop(ip, permuted, seeds, sizes, ref,
                              method=method,
                              indices_rows=sample.as_index_rows(permuted),
                              eid=smap)
    for a, b in zip(got, want):
        for f in ("n_id", "row", "col"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert (a.e_id is None) == (not with_eid)
        if with_eid:
            assert torch.equal(a.e_id.long(), b.e_id.long())
    assert torch.equal(gen.get_state(), after)


def _jax_raises(**kw):
    try:
        jsample_multihop(*kw.pop("args"), **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["weight_rows_alone", "weight_rows_exact",
                                  "windowed_rows_no_weight_rows",
                                  "exact_weighted_rows",
                                  "weight_rows_no_indices_rows"])
def test_multihop_value_errors_match_jax(graph, case):
    indptr, indices = graph
    e = indices.shape[0]
    w = np.ones(e, np.float32)
    rows = np.asarray(jsample.as_index_rows(jnp.asarray(indices)))
    kw = {"weight_rows_alone": dict(weight_rows=rows, method="rotation",
                                    indices_rows=rows),
          "weight_rows_exact": dict(weight_rows=rows, edge_weight=w),
          "windowed_rows_no_weight_rows": dict(edge_weight=w,
                                               method="window",
                                               indices_rows=rows),
          "exact_weighted_rows": dict(edge_weight=w, indices_rows=rows),
          "weight_rows_no_indices_rows": dict(
              edge_weight=w, weight_rows=rows.astype(np.float32),
              method="rotation"),
          }[case]
    seeds = np.arange(4, dtype=np.int32)
    want = _jax_raises(args=(jnp.asarray(indptr), jnp.asarray(indices),
                             jnp.asarray(seeds), [2], KEY),
                       **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                          else v for k, v in kw.items()})
    assert want is not None
    with pytest.raises(ValueError) as got:
        sample_multihop(_t(indptr), _t(indices), _t(seeds), [2], _gen(0),
                        **{k: _t(v) if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})
    assert str(got.value) == want


def test_multihop_refusals(graph):
    indptr, indices = graph
    ip, ix = _t(indptr), _t(indices)
    seeds = _t(np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="unknown sampling method"):
        sample_multihop(ip, ix, seeds, [2], _gen(0), method="walk")
    # weights run the pool draw (ops/weighted.py) on every hop
    n_id, layers = sample_multihop(ip, ix, seeds, [2], _gen(0),
                                   edge_weight=torch.ones(ix.shape[0]))
    _eq(layers[0].n_id[:4], np.arange(4), "weighted frontier")
    deg = torch.from_numpy(np.diff(indptr)[:4])
    assert int(layers[0].edge_count) == int(deg.clamp(max=2).sum())
    # the collector is ported (tests/test_torch_metrics.py)
    from quiver_tpu_torch.metrics import FRONTIER_CAP, Collector
    col = Collector()
    n_id, _ = sample_multihop(ip, ix, seeds, [2], _gen(0), collector=col)
    assert int(col.counters()[FRONTIER_CAP]) == n_id.shape[0]
    with pytest.raises(ValueError, match="stride=128 requires"):
        sample_multihop(ip, ix, seeds, [2], _gen(0), method="rotation",
                        indices_rows=sample.as_index_rows(ix),
                        indices_stride=128)


def test_multihop_dedup_matches_jax_compaction(graph):
    indptr, indices = graph
    batch = np.array([5, 9, 5, 30, 9, 2, 77], np.int32)
    n_id, layers, locs = sample_multihop_dedup(
        _t(indptr), _t(indices), _t(batch), [3, 2], _gen(0))
    ub, _, jlocs = jsample.compact_ids(jnp.asarray(batch))
    _eq(locs, jlocs, "batch locals")
    _eq(layers[0].n_id[:4], np.asarray(ub)[:4], "deduplicated batch")
    assert n_id.shape[0] == batch.shape[0] * 4 * 3


# -- random walks -------------------------------------------------------------

def test_random_walk_contract(graph):
    """The contract of ``tests/test_sample_ops.py``'s random-walk tests:
    ``paths[:, 0] == starts``, each step a neighbour of the last, a
    walker on a zero-degree node stays, a -1 walker stays -1; the same
    generator state gives the same walks; uniform over a row (chi-square
    at a fixed seed)."""
    indptr, indices = graph
    deg = np.diff(indptr)
    nsets = [set(indices[indptr[v]:indptr[v + 1]].tolist())
             for v in range(len(deg))]
    starts = np.concatenate([np.arange(60), [-1, 0, 50]]).astype(np.int32)
    paths = random_walk(_t(indptr), _t(indices), _t(starts), 3,
                                    _gen(4))
    assert paths.dtype == torch.int32 and tuple(paths.shape) == (63, 4)
    _eq(paths[:, 0], starts, "starts")
    _eq(paths, random_walk(_t(indptr), _t(indices), _t(starts),
                                       3, _gen(4)), "same generator")
    p = paths.numpy()
    for r in range(p.shape[0]):
        for t in range(3):
            a, b = p[r, t], p[r, t + 1]
            if a < 0:
                assert b == -1
            elif deg[a] == 0:
                assert b == a
            else:
                assert b in nsets[a]
    v = int(np.argmax(deg == 12)) if (deg == 12).any() else int(
        np.argmax(deg))
    walkers = torch.full((6000,), v, dtype=torch.int32)
    nxt = random_walk_step(_t(indptr), _t(indices), walkers,
                                       _gen(5))
    slot = {}
    for s_ in range(indptr[v], indptr[v + 1]):
        slot.setdefault(int(indices[s_]), 0)
        slot[int(indices[s_])] += 1
    ids = sorted(slot)
    hits = np.array([(nxt.numpy() == i).sum() for i in ids])
    assert hits.sum() == 6000
    want = 6000 * np.array([slot[i] for i in ids]) / deg[v]
    assert stats.chisquare(hits, want).pvalue > 1e-3


def test_random_walk_zero_degree_matches_jax():
    """The deterministic case of ``tests/test_sample_ops.py``: a
    zero-degree start stays, a one-edge row always moves, as JAX's."""
    from quiver_tpu.ops import random_walk as jrandom_walk
    indptr, indices = np.array([0, 0, 1]), np.array([0], np.int32)
    starts = np.array([0, 1, -1], np.int32)
    got = random_walk(_t(indptr), _t(indices), _t(starts), 2,
                                  _gen(0))
    want = jrandom_walk(jnp.asarray(indptr), jnp.asarray(indices),
                        jnp.asarray(starts), 2, KEY)
    _eq(got, want)
    assert got.tolist() == [[0, 0, 0], [1, 0, 0], [-1, -1, -1]]
