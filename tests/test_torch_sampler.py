"""The port's ``GraphSageSampler`` (``quiver_tpu_torch/pyg/sage_sampler.py``)
on the CPU against the JAX package's (``quiver_tpu/pyg/sage_sampler.py``),
mirroring ``tests/test_sampler_api.py`` and ``tests/test_exact_bucketed.py``.

Shapes, ``Adj.size``, the argument checks, the IPC handles, the rows
views, the compaction (``reindex``) and the probabilities are held to
JAX on the same numpy inputs (the probabilities within 1e-5). The picks
come from a ``torch.Generator``, so they are held by contract: every
sampled edge is a graph edge, its ``e_id`` names the COO edge under
exact, rotation, window and butterfly composition, and the same seed
gives the same sample. HOST mode (the topology in host memory, plain
host memory here) gives HBM mode's output bit for bit in every method;
the card runs the same check with pinned memory
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import quiver_tpu as jqv
import quiver_tpu_torch as qt
from quiver_tpu.ops import sample as jsample
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu_torch import CSRTopo, GraphSageSampler, SampleJob
from quiver_tpu_torch.pyg import Adj

METHODS = [dict(sampling="exact", wide_exact=False),
           dict(sampling="exact"),
           dict(sampling="exact", layout="overlap"),
           dict(sampling="rotation"),
           dict(sampling="rotation", layout="overlap"),
           dict(sampling="rotation", layout="overlap", shuffle="butterfly"),
           dict(sampling="window"),
           dict(sampling="window", layout="overlap", shuffle="butterfly")]
METHOD_IDS = ["scattered", "wide-pair", "wide-overlap", "rot-pair-sort",
              "rot-overlap-sort", "rot-overlap-bfly", "win-pair-sort",
              "win-overlap-bfly"]


@pytest.fixture(scope="module")
def csr():
    g = np.random.default_rng(0)
    n = 150
    deg = g.integers(0, 12, n)
    deg[[3, 40]] = 300                       # hubs above the 256 window
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = g.integers(0, n, int(indptr[-1]))
    return indptr, indices


@pytest.fixture
def topo(csr):
    return CSRTopo(indptr=csr[0], indices=csr[1], device="cpu")


def _sampler(topo, sizes, **kw):
    return GraphSageSampler(topo, sizes, device="cpu", **kw)


def check_sample_output(csr, seeds, n_id, adjs, sizes):
    """Distinct frontier, seeds first, every valid edge a graph edge."""
    indptr, indices = csr
    n_id = n_id.numpy()
    nsets = [set(indices[indptr[v]:indptr[v + 1]].tolist())
             for v in range(len(indptr) - 1)]
    valid = n_id[n_id >= 0]
    assert len(np.unique(valid)) == len(valid)
    np.testing.assert_array_equal(valid[:len(seeds)], seeds)
    assert len(adjs) == len(sizes)
    checked = 0
    for adj in adjs:
        src, dst = adj.edge_index.numpy()
        ok = src >= 0
        np.testing.assert_array_equal(adj.mask.numpy(), ok)
        assert (dst[ok] >= 0).all()
        for s_local, d_local in zip(src[ok], dst[ok]):
            assert n_id[s_local] in nsets[n_id[d_local]]
            checked += 1
    assert checked > 0


def _same(a, b):
    """Two samples equal bit for bit: n_id, batch size, every adj."""
    (n1, b1, a1), (n2, b2, a2) = a, b
    assert torch.equal(n1, n2) and b1 == b2 and len(a1) == len(a2)
    for x, y in zip(a1, a2):
        assert torch.equal(x.edge_index, y.edge_index)
        assert torch.equal(x.mask, y.mask) and x.size == y.size
        assert (x.e_id is None) == (y.e_id is None)
        if x.e_id is not None:
            assert torch.equal(x.e_id, y.e_id)


@pytest.mark.parametrize("kw", METHODS, ids=METHOD_IDS)
def test_shapes_and_sizes_match_jax(csr, topo, kw):
    seeds = np.random.default_rng(1).choice(np.arange(4, 150), 31,
                                            replace=False)
    seeds = np.concatenate([[3], seeds])          # a hub first
    n_id, bs, adjs = _sampler(topo, [5, 3], **kw).sample(seeds)
    jtopo = jqv.CSRTopo(indptr=csr[0], indices=csr[1])
    jn, jbs, jadjs = JSampler(jtopo, [5, 3], **kw).sample(seeds)
    assert bs == jbs == 32
    assert tuple(n_id.shape) == tuple(jn.shape) == (768,)
    assert [a.size for a in adjs] == [a.size for a in jadjs] == \
        [(768, 192), (192, 32)]
    for a, j in zip(adjs, jadjs):
        assert tuple(a.edge_index.shape) == tuple(j.edge_index.shape)
        assert a.edge_index.dtype == torch.int32 and a.e_id is None
    check_sample_output(csr, seeds, n_id, adjs, [5, 3])


@pytest.mark.parametrize("kw", METHODS, ids=METHOD_IDS)
def test_deterministic_under_the_same_seed(topo, kw):
    seeds = np.arange(20, 36)
    a = _sampler(topo, [4, 2], seed=7, **kw)
    b = _sampler(topo, [4, 2], seed=7, **kw)
    for _ in range(2):
        _same(a.sample(seeds), b.sample(seeds))
    c = _sampler(topo, [4, 2], seed=8, **kw).sample(seeds)
    assert not torch.equal(c[0], a.sample(seeds)[0]) or \
        not torch.equal(c[2][0].edge_index, a.sample(seeds)[2][0].edge_index)


@pytest.mark.parametrize("kw", METHODS, ids=METHOD_IDS)
def test_host_mode_equals_hbm_mode(topo, kw):
    seeds = np.random.default_rng(2).choice(150, 24, replace=False)
    hbm = _sampler(topo, [5, 3, 2], mode="HBM", seed=3, with_eid=True, **kw)
    host = _sampler(topo, [5, 3, 2], mode="HOST", seed=3, with_eid=True,
                    **kw)
    for epoch in range(2):
        _same(hbm.sample(seeds), host.sample(seeds))
        if kw["sampling"] != "exact":
            hbm.reshuffle()
            host.reshuffle()
    if kw["sampling"] == "exact" and kw.get("wide_exact", True):
        assert host._exact_rows is not None


def test_host_mode_pinned_buffers_are_reused(topo):
    s = _sampler(topo, [3], mode="HOST", sampling="rotation",
                 shuffle="butterfly", with_eid=True)
    s.sample(np.arange(8))
    bufs = (s._rot, s._permuted, s._rot_eid)
    rows = s._rot.clone()
    s.reshuffle()
    assert all(a is b for a, b in zip(bufs, (s._rot, s._permuted,
                                             s._rot_eid)))
    assert not torch.equal(rows, s._rot)
    assert s._row_ids is None          # HOST mode keeps no E-sized row ids


def test_wide_exact_opt_out_draws_the_same(topo):
    seeds = np.arange(8)
    wide = _sampler(topo, [4, 3], seed=7)
    narrow = _sampler(topo, [4, 3], seed=7, wide_exact=False)
    _same(wide.sample(seeds), narrow.sample(seeds))
    assert narrow._exact_rows is None and wide._exact_rows is not None
    assert wide._exact_hub_frac() == topo.exact_bucket_meta().frac
    assert narrow._exact_hub_frac() is None


def test_rows_np_matches_both_layouts(csr):
    flat = csr[1].astype(np.int32)
    for overlap, build in ((False, jsample.as_index_rows),
                           (True, jsample.as_index_rows_overlapping)):
        got = GraphSageSampler._rows_np(flat, overlap=overlap)
        np.testing.assert_array_equal(got, np.asarray(build(flat)))
        np.testing.assert_array_equal(
            got, JSampler._rows_np(flat, overlap=overlap))


def test_reindex_matches_jax_compact_layer():
    g = np.random.default_rng(3)
    inputs = g.choice(100, 10, replace=False).astype(np.int32)
    outputs = g.integers(-1, 100, (10, 4)).astype(np.int32)
    topo = CSRTopo(indptr=np.array([0, 0]), indices=np.zeros(0),
                   device="cpu")
    got = _sampler(topo, [4]).reindex(inputs, outputs)
    want = jsample.compact_layer(inputs, outputs)
    for f in ("n_id", "n_count", "row", "col", "edge_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("mode", ["HBM", "HOST"])
def test_sample_prob_and_sample_layer(csr, topo, mode):
    train = np.arange(0, 150, 7)
    s = _sampler(topo, [4, 2], mode=mode)
    got = s.sample_prob(train, 150)
    jtopo = jqv.CSRTopo(indptr=csr[0], indices=csr[1])
    want = JSampler(jtopo, [4, 2]).sample_prob(train, 150)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    nbrs, counts = s.sample_layer(np.array([3, 5, -1]), 4)
    assert tuple(nbrs.shape) == (3, 4)
    assert counts.tolist() == np.minimum(np.append(np.diff(csr[0])[[3, 5]],
                                                   0), 4).tolist()


# -- argument checks, as the JAX sampler's ------------------------------------

BAD = {"mode": dict(mode="DISK"),
       "weight_length": dict(edge_weight=np.ones(3, np.float32)),
       "sampling": dict(sampling="reservoir"),
       "rotation_fanout": dict(sampling="rotation", sizes=[200]),
       "window_fanout": dict(sampling="window", sizes=[129]),
       "layout": dict(layout="wide"),
       "shuffle": dict(shuffle="fisher"),
       "butterfly_weights": dict(sampling="window", shuffle="butterfly",
                                 edge_weight="full")}


@pytest.mark.parametrize("case", list(BAD))
def test_value_errors_match_jax(csr, topo, case):
    kw = dict(BAD[case])
    sizes = kw.pop("sizes", [5])
    if isinstance(kw.get("edge_weight"), str):
        kw["edge_weight"] = np.ones(topo.edge_count, np.float32)
    jtopo = jqv.CSRTopo(indptr=csr[0], indices=csr[1])
    with pytest.raises(ValueError) as want:
        JSampler(jtopo, sizes, **kw)
    with pytest.raises(ValueError) as got:
        _sampler(topo, sizes, **kw)
    assert str(got.value) == str(want.value)


def test_allowed_combinations(topo):
    # unweighted window + butterfly is allowed, as in the JAX package
    _sampler(topo, [5], sampling="window", shuffle="butterfly")
    _sampler(topo, [128], sampling="rotation")
    assert _sampler(topo, [3], mode="UVA").mode == "HOST"
    assert _sampler(topo, [3], mode="GPU").mode == "HBM"


@pytest.mark.parametrize("kw,item", [
    (dict(mode="CPU"), "item 5"),
    (dict(mode="CPU", sampling="rotation"), "item 5"),
    (dict(mode="CPU", edge_weight="full"), "item 5"),
    # collect_metrics is ported (tests/test_torch_metrics.py); with the
    # CPU mode it still waits for the native engine
    pytest.param(dict(mode="CPU", collect_metrics=True), "item 5",
                 id="kw3-collect_metrics")])
def test_later_work_raises(topo, kw, item):
    """The CPU-mode samplers that waited for the native engine (ROADMAP
    Queue 1 ``item``) now build and sample on the host, windowed methods
    falling back to exact and no counters kept, as in the JAX package
    (``tests/test_torch_mixed.py`` holds CPU mode to JAX's bit for
    bit); no mode raises ``NotImplementedError`` any more."""
    kw = dict(kw)
    if isinstance(kw.get("edge_weight"), str):
        kw["edge_weight"] = np.ones(topo.edge_count, np.float32)
    s = _sampler(topo, [3], **kw)
    assert (s.mode, s.sampling) == ("CPU", "exact"), item
    n_id, bs, adjs = s.sample(np.arange(5, dtype=np.int32))
    assert bs == 5 and n_id.shape == (20,) and adjs[0].size == (20, 5)
    assert s.last_counters is None


def test_no_card_means_raise_not_cpu(topo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is used")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSageSampler(topo, [3])


# -- IPC handles --------------------------------------------------------------

def test_ipc_handle_roundtrip(csr, topo):
    s = _sampler(topo, [4, 2], sampling="rotation", layout="overlap",
                 shuffle="butterfly", wide_exact=False, allow_fallback=False)
    s2 = GraphSageSampler.lazy_from_ipc_handle(s.share_ipc())
    assert (s2.layout, s2.shuffle, s2.sampling, s2.wide_exact,
            s2.allow_fallback, s2.mode, s2.device) == \
        ("overlap", "butterfly", "rotation", False, False, "HBM",
         torch.device("cpu"))
    jtopo = jqv.CSRTopo(indptr=csr[0], indices=csr[1])
    jh = JSampler(jtopo, [4, 2], sampling="rotation", layout="overlap",
                  shuffle="butterfly", wide_exact=False,
                  allow_fallback=False).share_ipc()
    assert len(s.share_ipc()) == len(jh) == 11
    assert s.share_ipc()[2:] == tuple(
        list(x) if isinstance(x, list) else x for x in jh[2:])
    seeds = np.arange(8)
    n_id, bs, adjs = s2.sample(seeds)
    check_sample_output(csr, seeds, n_id, adjs, [4, 2])


def test_short_ipc_handles_take_the_defaults(topo):
    s = _sampler(topo, [4, 2], sampling="rotation", layout="overlap",
                 shuffle="butterfly", wide_exact=False, allow_fallback=False)
    s7 = GraphSageSampler.lazy_from_ipc_handle(s.share_ipc()[:7])
    assert (s7.layout, s7.shuffle, s7.sampling) == ("pair", "sort",
                                                    "rotation")
    s9 = GraphSageSampler.lazy_from_ipc_handle(s.share_ipc()[:9])
    assert (s9.layout, s9.shuffle, s9.wide_exact, s9.allow_fallback) == \
        ("overlap", "butterfly", True, True)
    assert s9.sample(np.arange(8))[1] == 8


# -- edge ids name COO edges --------------------------------------------------

def _coo_topo(n=120, e=900):
    coo = np.random.default_rng(4).integers(0, n, (2, e))
    return coo, CSRTopo(edge_index=coo, node_count=n, device="cpu")


def check_eids(coo, n_id, adjs):
    """Every valid sampled edge's e_id names its COO edge (source = the
    hop's seed, target = the sampled neighbour)."""
    n_id = n_id.numpy()
    checked = 0
    for adj in adjs:
        ei, eid, mask = adj.edge_index.numpy(), adj.e_id.numpy(), \
            adj.mask.numpy()
        np.testing.assert_array_equal(eid >= 0, mask)
        for j in np.nonzero(mask)[0]:
            assert coo[0, eid[j]] == n_id[ei[1, j]]
            assert coo[1, eid[j]] == n_id[ei[0, j]]
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("mode", ["HBM", "HOST"])
@pytest.mark.parametrize("kw", METHODS, ids=METHOD_IDS)
def test_eids_name_coo_edges(mode, kw):
    coo, topo = _coo_topo()
    s = _sampler(topo, [4, 3], mode=mode, with_eid=True, **kw)
    seeds = np.random.default_rng(5).choice(topo.node_count, 16,
                                            replace=False)
    for _ in range(3):                 # three epochs: butterfly composes
        n_id, bs, adjs = s.sample(seeds)
        check_eids(coo, n_id, adjs)
        if kw["sampling"] != "exact":
            s.reshuffle()


def test_eids_without_a_topology_map_are_csr_slots(csr, topo):
    s = _sampler(topo, [4], with_eid=True)
    n_id, _, (adj,) = s.sample(np.array([3, 40, 7]))
    indptr, indices = csr
    n_id = n_id.numpy()
    for j in np.nonzero(adj.mask.numpy())[0]:
        slot = int(adj.e_id[j])
        tgt = n_id[int(adj.edge_index[1, j])]
        assert indptr[tgt] <= slot < indptr[tgt + 1]
        assert indices[slot] == n_id[int(adj.edge_index[0, j])]


def test_e_id_off_by_default(topo):
    _, _, adjs = _sampler(topo, [4]).sample(np.arange(8))
    assert all(a.e_id is None and a.mask is not None for a in adjs)


# -- Adj and the package surface ----------------------------------------------

def test_adj_to_moves_every_tensor():
    ei = torch.tensor([[0, -1], [1, -1]], dtype=torch.int32)
    adj = Adj(ei, torch.tensor([5, -1]), (3, 2))
    moved = adj.to(torch.device("cpu"))
    assert moved is not adj and moved.size == (3, 2)
    assert torch.equal(moved.edge_index, ei)
    assert moved.mask.tolist() == [True, False]
    assert moved.e_id.tolist() == [5, -1]
    assert Adj(ei, None, (3, 2)).to("cpu").e_id is None
    edge_index, e_id, size = moved
    assert size == (3, 2)


def test_exports_and_sample_job():
    assert qt.GraphSageSampler is GraphSageSampler
    assert qt.SampleJob is SampleJob
    job = SampleJob()
    for call in (lambda: job[0], lambda: len(job), job.shuffle):
        with pytest.raises(NotImplementedError):
            call()
