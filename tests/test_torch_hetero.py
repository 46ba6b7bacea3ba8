"""The port's typed-graph path (``quiver_tpu_torch/hetero.py``,
``hetero_feature.py``, ``models/rgcn.py``, ``models/mag.py`` and their
converters) against the JAX package's on the CPU, mirroring
``tests/test_hetero.py`` at its sizes (120 papers, 80 authors, 20
institutions, width 16).

The two packages' random streams differ, so the sampler is held to JAX
by contract in every mode (exact scattered and wide, rotation with sort
and butterfly over the pair and overlap layouts, window): every sampled
edge is an edge of its relation, ``counts == min(deg, k)``, the picks of
a target are distinct CSR slots, each frontier starts with the one before
the hop, rotation's marginal is uniform across reshuffles, and
``frontier_cap`` masks; each guard raises JAX's error text. The hop
assembly is held to JAX's exactly: JAX's picks, rebuilt from its output,
go through the port's ``assemble_hop``, whose frontiers, counts, COO,
edge ids, sizes and key order equal JAX's bit for bit.

``HeteroFeature`` equals JAX's lookup bit for bit on the same frontiers
(fp32 stores: tiered, hot-order reindexed, the paper tier moved to an
mmap file; int8 through ``Feature`` held to the two-rounding decode of
JAX's stored tiers bit for bit and to JAX's own lookup within one
rounding, as ``tests/test_torch_feature.py`` explains). The models run
on flax parameters carried across by the converters: ``RGCN`` within
1e-5 of flax, ``MAG240MGNN`` within 1e-4 (LayerNorm: flax's variance is
E[x^2] - E[x]^2, torch's E[(x - E[x])^2], which round differently), one
Adam step within 1e-6 (loss) and 1e-5 (parameters)."""

import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quiver_tpu as jqv
from quiver_tpu.hetero import HeteroCSRTopo as JTopo
from quiver_tpu.hetero import HeteroGraphSageSampler as JSampler
from quiver_tpu.models import MAG240MGNN as FlaxMAG
from quiver_tpu.models import RGCN as FlaxRGCN
from quiver_tpu.parallel.train import masked_feature_gather
from quiver_tpu_torch import (CSRTopo, GraphSageSampler, HeteroCSRTopo,
                              HeteroFeature, HeteroGraphSageSampler)
from quiver_tpu_torch.hetero import HeteroLayer, assemble_hop
from quiver_tpu_torch.models import (MAG240MGNN, RGCN,
                                     mag_flax_to_state_dict,
                                     mag_state_dict_to_flax,
                                     random_mag_flax_params,
                                     random_rgcn_flax_params,
                                     rgcn_flax_to_state_dict,
                                     rgcn_state_dict_to_flax)
from quiver_tpu_torch.pyg import Adj

N = {"paper": 120, "author": 80, "inst": 20}
CITES = ("paper", "cites", "paper")
WRITES = ("author", "writes", "paper")
EMPLOYS = ("inst", "employs", "author")
DIM = 16
ONE_ROUNDING = 2.0 ** -20          # as in tests/test_torch_feature.py
MODES = [dict(sampling="exact", wide_exact=False),
         dict(sampling="exact"),
         dict(sampling="exact", layout="overlap"),
         dict(sampling="rotation"),
         dict(sampling="rotation", shuffle="butterfly"),
         dict(sampling="rotation", layout="overlap"),
         dict(sampling="rotation", layout="overlap", shuffle="butterfly"),
         dict(sampling="window"),
         dict(sampling="window", layout="overlap", shuffle="butterfly")]
MODE_IDS = ["scattered", "wide-pair", "wide-overlap", "rot-pair-sort",
            "rot-pair-bfly", "rot-overlap-sort", "rot-overlap-bfly",
            "win-pair-sort", "win-overlap-bfly"]


def rel_csr(rng, n_dst, n_src, avg_deg):
    deg = rng.integers(0, 2 * avg_deg, n_dst)
    indptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, rng.integers(0, n_src, int(indptr[-1]))


@pytest.fixture(scope="module")
def raw():
    """``tests/test_hetero.py``'s ``mag_like`` relations, as numpy."""
    rng = np.random.default_rng(0)
    return {CITES: rel_csr(rng, N["paper"], N["paper"], 4),
            WRITES: rel_csr(rng, N["paper"], N["author"], 3),
            EMPLOYS: rel_csr(rng, N["author"], N["inst"], 2)}


def port_topo(raw, counts=N):
    return HeteroCSRTopo({et: CSRTopo(indptr=ip, indices=ix, device="cpu")
                          for et, (ip, ix) in raw.items()}, counts)


def jax_topo(raw, counts=N):
    return JTopo({et: jqv.CSRTopo(indptr=ip, indices=ix)
                  for et, (ip, ix) in raw.items()}, counts)


def sampler(topo, sizes, **kw):
    kw.setdefault("seed_type", "paper")
    return HeteroGraphSageSampler(topo, sizes, device="cpu", **kw)


def seeds_of(n=16, seed=1):
    return np.random.default_rng(seed).choice(N["paper"], n, replace=False)


def _np(t):
    return None if t is None else np.asarray(t)


def check_contract(raw, seeds, layers, sizes, seed_type="paper",
                   capped=False, weighted=()):
    """Every hop in sampling order: frontiers start with the frontier
    before the hop, valid entries distinct, counts right; every valid
    edge's e_id is a CSR slot of its target's row holding its source;
    per target ``min(deg, k)`` edges (unless a cap masks some), at
    distinct slots (unless the relation draws with replacement)."""
    pre = {seed_type: np.asarray(seeds)}
    checked = 0
    for hop, layer in enumerate(layers[::-1]):
        fan = sizes[hop] if isinstance(sizes[hop], dict) \
            else {et: sizes[hop] for et in raw}
        for t, f in layer.frontier.items():
            if f is None:
                assert pre.get(t) is None
                continue
            f = f.numpy()
            valid = f[f >= 0]
            assert len(np.unique(valid)) == len(valid)
            assert (f[len(valid):] == -1).all()
            if pre.get(t) is not None:
                before = pre[t][pre[t] >= 0]
                np.testing.assert_array_equal(valid[:len(before)], before)
            if t in layer.counts:
                assert int(layer.counts[t]) == len(valid)
        for et, adj in layer.adjs.items():
            indptr, indices = raw[et]
            k = fan[et]
            dst_front = pre[et[2]]
            src_front = layer.frontier[et[0]].numpy()
            s = dst_front.shape[0]
            assert adj.size == (src_front.shape[0], s)
            src, dst = adj.edge_index.numpy()
            ok = src >= 0
            np.testing.assert_array_equal(adj.mask.numpy(), ok)
            np.testing.assert_array_equal(
                dst, np.where(ok, np.repeat(np.arange(s), k), -1))
            e_id = adj.e_id.numpy()
            assert (e_id[~ok] == -1).all()
            for r in range(s):
                g = dst_front[r]
                sel = ok[r * k:(r + 1) * k]
                slots = e_id[r * k:(r + 1) * k][sel]
                srcs = src_front[src[r * k:(r + 1) * k][sel]]
                if g < 0:
                    assert not sel.any()
                    continue
                assert ((indptr[g] <= slots) & (slots < indptr[g + 1])).all()
                np.testing.assert_array_equal(indices[slots], srcs)
                deg = int(indptr[g + 1] - indptr[g])
                if not capped:
                    assert sel.sum() == min(deg, k), (et, g)
                if et not in weighted:
                    assert len(np.unique(slots)) == len(slots)
                checked += int(sel.sum())
        pre = {t: _np(f) for t, f in layer.frontier.items()}
    assert checked > 0


# -- the sampler by contract -------------------------------------------------

class TestSamplerContract:
    @pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
    def test_contract_every_mode(self, raw, kw):
        s = sampler(port_topo(raw), [3, 2], with_eid=True, seed=3, **kw)
        seeds = seeds_of()
        for _ in range(2):
            frontier, bs, layers = s.sample(seeds)
            assert bs == 16 and len(layers) == 2
            check_contract(raw, seeds, layers, [3, 2])
            assert frontier is layers[0].frontier
            if kw["sampling"] != "exact":
                s.reshuffle()

    def test_frontier_types_and_prefix(self, raw):
        seeds = seeds_of()
        frontier, bs, layers = sampler(port_topo(raw), [3, 2]).sample(seeds)
        assert bs == 16 and len(layers) == 2
        np.testing.assert_array_equal(frontier["paper"].numpy()[:16], seeds)
        inner = layers[-1].frontier["paper"].numpy()
        outer = layers[0].frontier["paper"].numpy()
        inner_valid = inner[inner >= 0]
        np.testing.assert_array_equal(outer[:len(inner_valid)], inner_valid)

    def test_key_order_and_shapes_equal_jax(self, raw):
        """Dicts come back sorted, as from JAX's jitted sampler, with
        JAX's capacities, ``None`` for a type not reached, and JAX's
        dtypes for the COO and counts."""
        seeds = seeds_of()
        for sizes in ([3, 2], [{CITES: 4}], [{WRITES: 2, CITES: 3}, 2]):
            jf, _, jl = JSampler(jax_topo(raw), sizes,
                                 seed_type="paper").sample(seeds)
            tf, _, tl = sampler(port_topo(raw), sizes).sample(seeds)
            assert list(tf) == list(jf) == sorted(jf)
            for a, b in zip(tl, jl):
                assert list(a.adjs) == list(b.adjs) == sorted(b.adjs)
                assert list(a.frontier) == list(b.frontier)
                assert list(a.counts) == list(b.counts)
                for t in b.frontier:
                    assert (a.frontier[t] is None) == (b.frontier[t] is None)
                    if b.frontier[t] is not None:
                        assert a.frontier[t].shape == b.frontier[t].shape
                        assert a.frontier[t].dtype == torch.int32
                for et, adj in b.adjs.items():
                    assert a.adjs[et].size == adj.size
                    assert a.adjs[et].edge_index.shape == adj.edge_index.shape
                    assert a.adjs[et].edge_index.dtype == torch.int32
                for t in b.counts:
                    assert a.counts[t].dtype == torch.int32

    def test_membership_per_relation(self, raw):
        seeds = seeds_of(8)
        _, _, layers = sampler(port_topo(raw), [3]).sample(seeds)
        layer = layers[0]
        for et, adj in layer.adjs.items():
            indptr, indices = raw[et]
            src_front = layer.frontier[et[0]].numpy()
            src, dst = adj.edge_index.numpy()
            ok = src >= 0
            for s_local, d_local in zip(src[ok], dst[ok]):
                g_dst = seeds[d_local]
                assert src_front[s_local] in \
                    indices[indptr[g_dst]:indptr[g_dst + 1]]

    def test_per_relation_fanout_dict(self, raw):
        _, _, layers = sampler(port_topo(raw), [{CITES: 4}]).sample(
            seeds_of(8))
        assert set(layers[0].adjs) == {CITES}
        assert layers[0].frontier["author"] is None

    def test_rotation_marginal_uniform_across_reshuffles(self):
        # tests/test_hetero.py's calibration: 64 rows x 2 draws x 60
        # epochs, the 0.02 tolerance at ~6 sigma
        n_dst, deg = 64, 12
        et = ("s", "r", "d")
        topo = HeteroCSRTopo(
            {et: CSRTopo(indptr=np.arange(n_dst + 1) * deg,
                         indices=np.tile(np.arange(deg), n_dst),
                         device="cpu")}, {"s": deg, "d": n_dst})
        s = sampler(topo, [2], seed_type="d", sampling="rotation")
        hits = np.zeros(deg)
        for _ in range(60):
            s.reshuffle()
            _, _, layers = s.sample(np.arange(n_dst, dtype=np.int64))
            f = layers[0].frontier["s"].numpy()
            src = layers[0].adjs[et].edge_index[0].numpy()
            np.add.at(hits, f[src[src >= 0]], 1)
        np.testing.assert_allclose(hits / hits.sum(), 1 / deg, atol=0.02)

    def test_frontier_cap_truncates_and_masks(self, raw):
        cap = 24
        seeds = seeds_of()
        s = sampler(port_topo(raw), [3, 2], frontier_cap=cap, with_eid=True)
        frontier, _, layers = s.sample(seeds)
        for f in frontier.values():
            if f is not None:
                assert f.shape[0] <= cap
        for layer in layers:
            for c in layer.counts.values():
                assert int(c) <= cap
            for adj in layer.adjs.values():
                ei = adj.edge_index.numpy()
                assert (ei[0][adj.mask.numpy()] < cap).all()
                assert (adj.e_id.numpy()[~adj.mask.numpy()] == -1).all()
        np.testing.assert_array_equal(frontier["paper"].numpy()[:16], seeds)
        check_contract(raw, seeds, layers, [3, 2], capped=True)

    def test_per_type_cap_dict(self, raw):
        frontier, _, _ = sampler(port_topo(raw), [3, 2],
                                 frontier_cap={"author": 10}) \
            .sample(seeds_of(8))
        assert frontier["author"].shape[0] <= 10
        assert frontier["paper"].shape[0] > 10

    def test_wide_exact_opt_out_identical(self, raw):
        """The wide path and the scattered draw give the same picks for
        the same seed (the wide read is the same draw)."""
        a = sampler(port_topo(raw), [3, 2], seed=5)
        b = sampler(port_topo(raw), [3, 2], seed=5, wide_exact=False)
        seeds = seeds_of(8)
        fa, _, la = a.sample(seeds)
        fb, _, lb = b.sample(seeds)
        assert a._rows is not None and b._rows is None
        assert set(a._hub_fracs) == set(raw)
        for t in fa:
            assert torch.equal(fa[t], fb[t])
        for x, y in zip(la, lb):
            for et in x.adjs:
                assert torch.equal(x.adjs[et].edge_index,
                                   y.adjs[et].edge_index)

    def test_same_seed_same_sample_and_butterfly_state(self, raw):
        seeds = seeds_of()
        outs = []
        for _ in range(2):
            s = sampler(port_topo(raw), [3, 2], sampling="rotation",
                        shuffle="butterfly", with_eid=True, seed=9)
            s.sample(seeds)
            assert set(s._permuted) == set(raw)
            s.reshuffle()
            outs.append(s.sample(seeds)[2])
        for x, y in zip(*outs):
            for et in x.adjs:
                assert torch.equal(x.adjs[et].edge_index,
                                   y.adjs[et].edge_index)
                assert torch.equal(x.adjs[et].e_id, y.adjs[et].e_id)


GUARDS = [
    dict(sizes=[3], sampling="bogus"),
    dict(sizes=[3], layout="bogus"),
    dict(sizes=[3], shuffle="bogus"),
    dict(sizes=[200], sampling="rotation"),
    dict(sizes=[3, {CITES: 129}], sampling="window"),
    dict(sizes=[3], sampling="rotation", edge_weight="cites"),
    dict(sizes=[3], edge_weight="unknown"),
    dict(sizes=[3], edge_weight="short"),
]


def _guard_kw(raw, kw):
    kw = dict(kw)
    w = kw.pop("edge_weight", None)
    e = raw[CITES][1].shape[0]
    if w == "cites":
        kw["edge_weight"] = {CITES: np.ones(e, np.float32)}
    elif w == "unknown":
        kw["edge_weight"] = {("a", "b", "c"): np.ones(3, np.float32)}
    elif w == "short":
        kw["edge_weight"] = {CITES: np.ones(e + 1, np.float32)}
    return kw


@pytest.mark.parametrize("kw", GUARDS, ids=[
    "sampling", "layout", "shuffle", "rotation-k", "window-k",
    "weighted-rotation", "weight-unknown", "weight-length"])
def test_guards_raise_jax_text(raw, kw):
    kw = _guard_kw(raw, kw)
    sizes = kw.pop("sizes")
    with pytest.raises(ValueError) as want:
        JSampler(jax_topo(raw), sizes, seed_type="paper", **kw)
    with pytest.raises(ValueError) as got:
        sampler(port_topo(raw), sizes, **kw)
    assert str(got.value) == str(want.value)


def test_sample_guards_raise_jax_text(raw):
    """The cap below the batch (at ``sample``), ``reshuffle`` in exact
    mode, and the topology's row-count check."""
    seeds = seeds_of(8)
    with pytest.raises(ValueError) as want:
        JSampler(jax_topo(raw), [3], seed_type="paper",
                 frontier_cap=4).sample(seeds)
    with pytest.raises(ValueError, match="batch size") as got:
        sampler(port_topo(raw), [3], frontier_cap=4).sample(seeds)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JSampler(jax_topo(raw), [3], seed_type="paper").reshuffle()
    with pytest.raises(ValueError, match="rotation/window") as got:
        sampler(port_topo(raw), [3]).reshuffle()
    assert str(got.value) == str(want.value)
    big = dict(N, author=500)
    with pytest.raises(ValueError) as want:
        jax_topo(raw, big)
    with pytest.raises(ValueError) as got:
        port_topo(raw, big)
    assert str(got.value) == str(want.value)


def test_no_card_raises_without_cpu_request(raw):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeteroGraphSageSampler(port_topo(raw), [3], seed_type="paper")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeteroFeature.from_cpu_tensors(
            {"paper": np.zeros((4, 2), np.float32)})


# -- the hop assembly, bit for bit --------------------------------------------

def _rebuilt_hops(jsampler, seeds, jlayers):
    """Per hop in sampling order, JAX's per-relation picks rebuilt from
    its output (``frontier[src][edge_index[0]]`` where the mask holds,
    -1 elsewhere) in its sampling order: ``[(layer, {et: (nbrs [s, k],
    e_id [s, k] or None)})]``."""
    hops = []
    for fanouts, layer in zip(jsampler.sizes, jlayers[::-1]):
        picks = {}
        for et in fanouts:
            if et not in layer.adjs:
                continue
            adj = layer.adjs[et]
            s = adj.size[1]
            src = np.asarray(layer.frontier[et[0]])
            ei, m = np.asarray(adj.edge_index), np.asarray(adj.mask)
            nbrs = np.where(m, src[np.maximum(ei[0], 0)], -1).reshape(s, -1)
            e_id = None if adj.e_id is None else \
                np.asarray(adj.e_id).reshape(s, -1)
            picks[et] = (nbrs.astype(np.int32),
                         None if e_id is None else e_id.copy())
        hops.append((layer, picks))
    return hops


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("sizes,kw", [
    ([3, 2], {}),
    ([3, 2], dict(with_eid=True)),
    ([3, 2], dict(frontier_cap=24, with_eid=True)),
    ([4, 3], dict(frontier_cap={"author": 10, "inst": 6})),
    ([{WRITES: 2, CITES: 3}, {EMPLOYS: 2, CITES: 2}], dict(with_eid=True)),
    ([3, 2], dict(sampling="rotation", with_eid=True)),
], ids=["plain", "eid", "cap", "cap-dict", "fanout-dicts", "rotation-eid"])
def test_assembly_equals_jax(raw, sizes, kw):
    seeds = seeds_of()
    js = JSampler(jax_topo(raw), sizes, seed_type="paper", seed=2, **kw)
    jfront, _, jlayers = js.sample(seeds)
    cap = js.frontier_cap
    frontier = {t: None for t in N}
    frontier["paper"] = torch.from_numpy(seeds.astype(np.int32))
    for layer, picks in _rebuilt_hops(js, seeds, jlayers):
        samples = {et: (frontier[et[2]], torch.from_numpy(nbrs),
                        None if e is None else torch.from_numpy(e))
                   for et, (nbrs, e) in picks.items()}
        adjs, frontier, counts = assemble_hop(frontier, samples, cap)
        assert list(adjs) == list(layer.adjs)
        assert list(frontier) == list(layer.frontier)
        assert list(counts) == list(layer.counts)
        for et, adj in layer.adjs.items():
            got = adjs[et]
            assert got.size == adj.size
            assert got.edge_index.dtype == torch.int32
            assert _same(got.edge_index, adj.edge_index)
            assert _same(got.mask, adj.mask)
            assert (got.e_id is None) == (adj.e_id is None)
            if adj.e_id is not None:
                assert _same(got.e_id, adj.e_id)
        for t, f in layer.frontier.items():
            assert (frontier[t] is None) == (f is None)
            if f is not None:
                assert frontier[t].dtype == torch.int32
                assert _same(frontier[t], f)
        for t, c in layer.counts.items():
            assert int(counts[t]) == int(c)
    assert [t for t in jfront] == list(frontier)


# -- edge ids and weights -----------------------------------------------------

class TestEidWeighted:
    def test_with_eid_maps_through_topo_eid(self):
        rng = np.random.default_rng(0)
        n = 60
        src = rng.integers(0, n, 400).astype(np.int64)
        dst = rng.integers(0, n, 400).astype(np.int64)
        topo = CSRTopo(edge_index=np.stack([src, dst]), device="cpu")
        h = HeteroCSRTopo({("x", "r", "x"): topo}, {"x": topo.node_count})
        seeds = rng.choice(topo.node_count, 8, replace=False)
        _, _, layers = sampler(h, [4], seed_type="x", with_eid=True) \
            .sample(seeds)
        adj = layers[0].adjs[("x", "r", "x")]
        src_front = layers[0].frontier["x"].numpy()
        sl, dl = adj.edge_index.numpy()
        e_id = adj.e_id.numpy()
        ok = sl >= 0
        assert ok.any()
        assert (src[e_id[ok]] == seeds[dl[ok]]).all()
        assert (dst[e_id[ok]] == src_front[sl[ok]]).all()

    @pytest.mark.parametrize("sampling,shuffle,layout", [
        ("rotation", "sort", "pair"), ("rotation", "butterfly", "overlap"),
        ("window", "sort", "pair"), ("window", "butterfly", "overlap")])
    def test_with_eid_rotation_window_across_reshuffles(self, sampling,
                                                        shuffle, layout):
        rng = np.random.default_rng(1)
        n = 60
        src = rng.integers(0, n, 500).astype(np.int64)
        dst = rng.integers(0, n, 500).astype(np.int64)
        topo = CSRTopo(edge_index=np.stack([src, dst]), device="cpu")
        h = HeteroCSRTopo({("x", "r", "x"): topo}, {"x": topo.node_count})
        s = sampler(h, [4], seed_type="x", sampling=sampling,
                    shuffle=shuffle, layout=layout, with_eid=True)
        seeds = rng.choice(topo.node_count, 8, replace=False)
        for epoch in range(3):
            _, _, layers = s.sample(seeds)
            adj = layers[0].adjs[("x", "r", "x")]
            src_front = layers[0].frontier["x"].numpy()
            sl, dl = adj.edge_index.numpy()
            e_id = adj.e_id.numpy()
            ok = sl >= 0
            assert ok.any()
            assert (src[e_id[ok]] == seeds[dl[ok]]).all(), epoch
            assert (dst[e_id[ok]] == src_front[sl[ok]]).all(), epoch
            assert len(np.unique(e_id[ok])) == ok.sum()
            s.reshuffle()

    def test_weighted_relation_draws_by_weight(self, raw):
        indptr, indices = raw[CITES]
        w = np.full(indices.shape[0], 1e-6, np.float32)
        first = indptr[:-1][indptr[:-1] < indptr[1:]]
        w[first] = 1e6
        seeds = seeds_of()
        s = sampler(port_topo(raw), [{CITES: 3}], edge_weight={CITES: w},
                    with_eid=True)
        _, _, layers = s.sample(seeds)
        adj = layers[0].adjs[CITES]
        sl, dl = adj.edge_index.numpy()
        e_id = adj.e_id.numpy()
        ok = sl >= 0
        assert ok.any()
        src_front = layers[0].frontier["paper"].numpy()
        g = seeds[dl[ok]]
        assert ((indptr[g] <= e_id[ok]) & (e_id[ok] < indptr[g + 1])).all()
        np.testing.assert_array_equal(indices[e_id[ok]], src_front[sl[ok]])
        assert (e_id[ok] == indptr[g]).mean() > 0.99
        check_contract(raw, seeds, layers, [{CITES: 3}], weighted={CITES})

    def test_weighted_marginal_follows_weights(self):
        """One row of 4 neighbours weighted 1:2:3:4, 64 seeds of it x 8
        draws x 20 batches: each slot's share within 0.02 of w / 10."""
        n_dst, deg = 64, 4
        et = ("s", "r", "d")
        topo = HeteroCSRTopo(
            {et: CSRTopo(indptr=np.arange(n_dst + 1) * deg,
                         indices=np.tile(np.arange(deg), n_dst),
                         device="cpu")}, {"s": deg, "d": n_dst})
        w = np.tile(np.arange(1, deg + 1, dtype=np.float32), n_dst)
        s = sampler(topo, [8], seed_type="d", edge_weight={et: w},
                    with_eid=True)
        hits = np.zeros(deg)
        for _ in range(20):
            _, _, layers = s.sample(np.arange(n_dst))
            e = layers[0].adjs[et].e_id.numpy()
            np.add.at(hits, e[e >= 0] % deg, 1)
        np.testing.assert_allclose(hits / hits.sum(),
                                   np.arange(1, deg + 1) / 10, atol=0.02)

    def test_mixed_weighted_and_uniform_relations(self, raw):
        e = raw[WRITES][1].shape[0]
        s = sampler(port_topo(raw), [3],
                    edge_weight={WRITES: np.ones(e, np.float32)},
                    with_eid=True)
        seeds = seeds_of(8)
        _, _, layers = s.sample(seeds)
        assert set(layers[0].adjs) == {CITES, WRITES}
        assert set(s._rows) == {CITES, EMPLOYS}
        check_contract(raw, seeds, layers, [3], weighted={WRITES})


# -- HeteroFeature ------------------------------------------------------------

def _feats(seed=0):
    rng = np.random.default_rng(seed)
    return {t: rng.standard_normal((c, DIM)).astype(np.float32)
            for t, c in N.items()}


def _both(feats, configs, default, placement="offload"):
    j = jqv.HeteroFeature.from_cpu_tensors(feats, configs=configs,
                                           default=default)
    t = HeteroFeature.from_cpu_tensors(
        feats, configs=configs,
        default=dict(default, device="cpu", host_placement=placement))
    return j, t


def _assert_lookup_equal(j, t, frontier):
    want = j.lookup({k: None if v is None else jnp.asarray(v)
                     for k, v in frontier.items()})
    got = t.lookup({k: None if v is None else torch.from_numpy(v)
                    for k, v in frontier.items()})
    assert list(got) == list(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        # a masked row is +-0.0 by the path's multiply, as in JAX
        assert g.shape == w.shape and np.array_equal(g, w), k
    return got


class TestHeteroFeature:
    @pytest.mark.parametrize("placement", ["offload", "numpy"])
    def test_lookup_equals_jax(self, placement):
        feats = _feats()
        j, t = _both(feats, {"paper": dict(device_cache_size=30 * DIM * 4)},
                     dict(device_cache_size="1M"), placement)
        assert t["paper"].cache_rows == 30 and t["author"].cache_rows == 80
        frontier = {"author": np.array([79, -1, 0]), "inst": None,
                    "paper": np.array([0, 55, 119, -1, 3])}
        out = _assert_lookup_equal(j, t, frontier)
        assert list(out) == ["author", "paper"]
        for k, ids in frontier.items():
            if ids is not None:
                want = feats[k][np.clip(ids, 0, None)] * (ids >= 0)[:, None]
                np.testing.assert_array_equal(out[k].numpy(), want)

    def test_hot_order_and_mmap_tier_equal_jax(self, raw, tmp_path):
        feats = _feats(1)
        n = N["paper"]
        cites = {CITES: raw[CITES]}
        jt = jax_topo(cites)
        pt = port_topo(cites)
        j = jqv.HeteroFeature.from_cpu_tensors(
            feats, configs={"paper": dict(device_cache_size=20 * DIM * 4,
                                          csr_topo=jt.rels[CITES])},
            default=dict(device_cache_size="1M"))
        t = HeteroFeature.from_cpu_tensors(
            feats, configs={"paper": dict(device_cache_size=20 * DIM * 4,
                                          csr_topo=pt.rels[CITES])},
            default=dict(device_cache_size="1M", device="cpu",
                         host_placement="offload"))
        np.testing.assert_array_equal(t["paper"].feature_order.numpy(),
                                      np.asarray(j["paper"].feature_order))
        ids = np.random.default_rng(2).integers(0, n, 40)
        ids[::9] = -1
        _assert_lookup_equal(j, t, {"paper": ids})
        order = t["paper"].feature_order.numpy()
        storage = np.empty_like(feats["paper"])
        storage[order] = feats["paper"]
        path = str(tmp_path / "paper.npy")
        np.save(path, storage)
        j["paper"].set_mmap_file(path, np.arange(n))
        t["paper"].set_mmap_file(path, np.arange(n))
        got = _assert_lookup_equal(j, t, {"paper": ids})
        np.testing.assert_array_equal(
            got["paper"].numpy(),
            feats["paper"][np.maximum(ids, 0)] * (ids >= 0)[:, None])

    def test_int8_paper_within_two_roundings(self, raw):
        """An int8 paper store (through ``Feature``): bit for bit the
        two-rounding decode of JAX's stored tiers, within one rounding
        of JAX's own lookup."""
        feats = _feats(2)
        cites = {CITES: raw[CITES]}
        cfg = lambda topo: {"paper": dict(  # noqa: E731
            device_cache_size=30 * (DIM + 8), dtype_policy="int8",
            csr_topo=topo.rels[CITES])}
        j = jqv.HeteroFeature.from_cpu_tensors(
            feats, configs=cfg(jax_topo(cites)),
            default=dict(device_cache_size="1M"))
        t = HeteroFeature.from_cpu_tensors(
            feats, configs=cfg(port_topo(cites)),
            default=dict(device_cache_size="1M", device="cpu",
                         host_placement="offload"))
        jp = j["paper"]
        assert t["paper"].cache_rows == jp.cache_rows == 30
        dec = np.concatenate([
            np.asarray(p.data).astype(np.float32) * np.asarray(p.scale)
            + np.asarray(p.zero) for p in (jp.device_part, jp.host_part)])
        ids = np.random.default_rng(3).integers(0, N["paper"], 50)
        ids[::7] = -1
        got = t.lookup({"paper": torch.from_numpy(ids)})["paper"].numpy()
        order = np.asarray(jp.feature_order)
        want = dec[order[np.maximum(ids, 0)]] * (ids >= 0)[:, None]
        np.testing.assert_array_equal(got, want)
        jax_own = np.asarray(j.lookup({"paper": jnp.asarray(ids)})["paper"])
        np.testing.assert_allclose(got, jax_own, rtol=0, atol=ONE_ROUNDING)

    def test_sampler_to_feature_pipeline(self, raw):
        feats = _feats()
        _, t = _both(feats, {"paper": dict(device_cache_size=40 * DIM * 4)},
                     dict(device_cache_size="1M"))
        _, _, layers = sampler(port_topo(raw), [3, 2]).sample(seeds_of(8))
        x = t.lookup(layers[0].frontier)
        assert list(x) == [k for k, v in layers[0].frontier.items()
                           if v is not None]
        for k, arr in x.items():
            ids = layers[0].frontier[k].numpy()
            assert arr.shape == (ids.shape[0], DIM)
            valid = ids >= 0
            np.testing.assert_array_equal(arr.numpy()[valid],
                                          feats[k][ids[valid]])
            assert (arr.numpy()[~valid] == 0).all()

    def test_unknown_config_type_rejected(self):
        with pytest.raises(ValueError) as want:
            jqv.HeteroFeature.from_cpu_tensors(_feats(), configs={"nope": {}})
        with pytest.raises(ValueError, match="unknown node type") as got:
            HeteroFeature.from_cpu_tensors(_feats(), configs={"nope": {}})
        assert str(got.value) == str(want.value)

    def test_mesh_sharded_type_is_item_7(self):
        """``tests/test_hetero.py::test_mesh_sharded_type``'s store (one
        type's cache sharded over a mesh), ROADMAP item 7's clique: the
        paper type's hot tier in 8 blocks, the others replicated (held
        to JAX's store in ``tests/test_torch_clique.py``)."""
        from quiver_tpu_torch.parallel import make_mesh
        feats = _feats()
        t = HeteroFeature.from_cpu_tensors(
            feats, configs={"paper": dict(
                device_cache_size=N["paper"] * DIM * 4 // 8,
                cache_policy="p2p_clique_replicate",
                mesh=make_mesh(("cache",), devices=["cpu"] * 8))},
            default=dict(device_cache_size="1M", device="cpu"))
        assert t["paper"].sharded and not t["author"].sharded
        ids = torch.tensor([0, 7, N["paper"] - 1, -1])
        out = t.lookup({"paper": ids})["paper"].numpy()
        np.testing.assert_array_equal(out[:3], feats["paper"][[0, 7, -1]])
        assert not out[3].any()

    def test_prefetch_pickle_and_accessors(self):
        feats = _feats()
        j, t = _both(feats, {"paper": dict(device_cache_size=30 * DIM * 4)},
                     dict(device_cache_size="1M"))
        frontier = {"paper": torch.tensor([5, -1, 100]), "inst": None,
                    "author": torch.tensor([0, 41])}
        buf = frontier["paper"]
        fut = t.prefetch(frontier)
        buf.fill_(7)                      # the ids were copied
        got = fut.result(timeout=30)
        frontier["paper"] = torch.tensor([5, -1, 100])
        want = t.lookup(frontier)
        assert list(got) == list(want) == ["paper", "author"]
        for k in want:
            assert torch.equal(got[k], want[k])
        back = pickle.loads(pickle.dumps(t))
        assert back._pool is None and t._pool is not None
        for k, v in back.lookup(frontier).items():
            assert torch.equal(v, want[k])
        assert t.node_types == j.node_types == ["paper", "author", "inst"]
        assert t.size("paper", 0) == j.size("paper", 0) == 120
        assert t.size("inst", 1) == DIM
        assert t["author"] is t.stores["author"]
        t.close()
        t.close()
        assert t._pool is None


CARD1 = torch.device("cuda", 1)


class _CardIds:
    """Ids that say they live on the second card."""

    device = CARD1

    def clone(self):
        return self

    def record_stream(self, stream):
        self.stream = stream


def test_prefetch_events_and_worker_on_the_ids_card(monkeypatch):
    """With ``torch.cuda`` patched: one ready event for all the types on
    the ids' card, recorded on that card's current stream; the worker
    enters that card and its staging stream, waits for the event, looks
    up, and records its done event on the staging stream."""
    recorded, entered = [], []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    class Stream:
        def __init__(self, device):
            self.device, self.waited = device, []

        def wait_event(self, ev):
            self.waited.append(ev)

    class Enter:
        def __init__(self, what):
            self.what = what

        def __enter__(self):
            entered.append(self.what)

        def __exit__(self, *exc):
            pass
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    monkeypatch.setattr(torch.cuda, "device", Enter)
    monkeypatch.setattr(torch.cuda, "stream", Enter)
    _, t = _both(_feats(), {}, dict(device_cache_size="1M"))
    monkeypatch.setattr(type(t["paper"]), "_ids", lambda self, x: _CardIds())
    submitted = []
    t._pool = type("Pool", (), {"submit": lambda self, fn, *a:
                                submitted.append((fn, a))})()
    t.prefetch({"paper": [1, 2], "inst": None, "author": [3]})
    assert recorded == [("stream of", CARD1)]
    stream = t._streams[CARD1]
    assert set(t._streams) == {CARD1} and stream.device == CARD1
    fn, (snap, ready) = submitted[0]
    assert list(snap) == ["paper", "inst", "author"]
    assert snap["paper"].stream is stream and snap["inst"] is None
    monkeypatch.setattr(HeteroFeature, "_lookup_one",
                        lambda self, ty, ids: f"rows of {ty}")
    rows, done = fn(snap, ready)
    assert entered == [CARD1, stream]
    assert stream.waited == [ready[CARD1][1]]
    assert rows == {"paper": "rows of paper", "author": "rows of author"}
    assert list(done) == [CARD1] and recorded[-1] is stream


# -- the models ---------------------------------------------------------------

def _jnp_x(feats, frontier):
    return {t: jnp.asarray(feats[t][np.maximum(np.asarray(f), 0)]
                           * (np.asarray(f) >= 0)[:, None])
            for t, f in frontier.items() if f is not None}


def _port_layers(jlayers):
    return [HeteroLayer(
        adjs={et: Adj(torch.from_numpy(np.array(a.edge_index)), None,
                      a.size) for et, a in layer.adjs.items()},
        frontier={t: None if f is None else torch.from_numpy(np.array(f))
                  for t, f in layer.frontier.items()},
        counts={}) for layer in jlayers]


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _assert_trees_equal(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        if tol:
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def rgcn_case(raw):
    """One JAX sample of [3, 2] from 16 papers, the features it needs,
    labels and flax R-GCN parameters from flax's ``init``."""
    feats = _feats(4)
    seeds = seeds_of()
    _, _, jlayers = JSampler(jax_topo(raw), [3, 2], seed_type="paper",
                             seed=6).sample(seeds)
    x = _jnp_x(feats, jlayers[0].frontier)
    fmodel = FlaxRGCN(hidden_dim=24, out_dim=5, num_layers=2,
                      seed_type="paper", dropout=0.0)
    params = jax.jit(fmodel.init)(jax.random.key(0), x, jlayers)
    y = np.random.default_rng(5).integers(0, 5, 16)
    return dict(feats=feats, jlayers=jlayers, x=x, fmodel=fmodel,
                params=params, y=y)


def _port_rgcn(jlayers, params, hidden=24, out=5):
    layers = _port_layers(jlayers)
    model = RGCN({t: DIM for t in N}, hidden, out, 2, "paper",
                 [list(lay.adjs) for lay in layers], dropout=0.0)
    model.load_state_dict(rgcn_flax_to_state_dict(_tree_np(params)))
    return model, layers


class TestModels:
    def test_rgcn_logits_equal_flax(self, rgcn_case):
        c = rgcn_case
        want = np.asarray(jax.jit(c["fmodel"].apply)(c["params"], c["x"],
                                                     c["jlayers"]))
        model, layers = _port_rgcn(c["jlayers"], c["params"])
        x = {t: torch.from_numpy(np.array(v)) for t, v in c["x"].items()}
        with torch.no_grad():
            got = model(x, layers).numpy()
        assert got.shape == want.shape == (16, 5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_rgcn_sums_relations_in_sorted_order(self, rgcn_case):
        """The relations of a layer reach the model sorted (the
        sampler's order): the port's sum follows it."""
        model, layers = _port_rgcn(rgcn_case["jlayers"],
                                   rgcn_case["params"])
        for layer in layers:
            assert list(layer.adjs) == sorted(layer.adjs)
        names = [n for n, _ in model.convs[0].named_children()]
        assert names == ["rel__author__writes__paper",
                         "rel__inst__employs__author",
                         "rel__paper__cites__paper",
                         "self__paper", "self__author"]

    def test_rgcn_adam_step_equals_optax(self, rgcn_case):
        c = rgcn_case
        y = jnp.asarray(c["y"])
        tx = optax.adam(1e-2)

        def loss_fn(p):
            logits = c["fmodel"].apply(p, c["x"], c["jlayers"])[:16]
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
        jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(c["params"])
        updates, _ = tx.update(grads, tx.init(c["params"]), c["params"])
        jparams = optax.apply_updates(c["params"], updates)

        model, layers = _port_rgcn(c["jlayers"], c["params"])
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        x = {t: torch.from_numpy(np.array(v)) for t, v in c["x"].items()}
        loss = torch.nn.functional.cross_entropy(
            model(x, layers)[:16], torch.from_numpy(c["y"]))
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert abs(loss.item() - float(jloss)) <= 1e-6
        _assert_trees_equal(rgcn_state_dict_to_flax(model.state_dict()),
                            _tree_np(jparams), rtol=0, atol=1e-5)

    def test_rgcn_converters_round_trip(self, rgcn_case):
        layers = _port_layers(rgcn_case["jlayers"])
        ets = [list(lay.adjs) for lay in layers]
        rand = random_rgcn_flax_params({t: DIM for t in N}, 24, 5, ets,
                                       seed=3)
        # the same layout and shapes as flax's own init
        assert _shapes(rand) == _shapes(rgcn_case["params"])
        model = RGCN({t: DIM for t in N}, 24, 5, 2, "paper", ets)
        model.load_state_dict(rgcn_flax_to_state_dict(rand))
        _assert_trees_equal(rgcn_state_dict_to_flax(model.state_dict()),
                            rand)
        with pytest.raises(ValueError, match="layers"):
            RGCN({t: DIM for t in N}, 24, 5, 3, "paper", ets)

    def test_rgcn_learns_through_the_port(self, raw):
        """``tests/test_hetero.py``'s learning check through the port's
        sampler and ``HeteroFeature``: 40 Adam steps on 3 classes whose
        centres shift the paper features."""
        rng = np.random.default_rng(7)
        feats = {t: rng.standard_normal((c, 8)).astype(np.float32)
                 for t, c in N.items()}
        labels = rng.integers(0, 3, N["paper"])
        feats["paper"] += 2.0 * rng.standard_normal((3, 8)) \
            .astype(np.float32)[labels]
        store = HeteroFeature.from_cpu_tensors(
            feats, default=dict(device_cache_size="1M", device="cpu"))
        s = sampler(port_topo(raw), [3, 2], seed=1)
        _, _, layers = s.sample(rng.choice(120, 16, replace=False))
        torch.manual_seed(0)
        model = RGCN({t: 8 for t in N}, 16, 3, 2, "paper",
                     [list(lay.adjs) for lay in layers], dropout=0.0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        losses = []
        for _ in range(40):
            seeds = rng.choice(120, 16, replace=False)
            _, bs, layers = s.sample(seeds)
            x = store.lookup(layers[0].frontier)
            loss = torch.nn.functional.cross_entropy(
                model(x, layers)[:bs], torch.from_numpy(labels[seeds]))
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


@pytest.fixture(scope="module")
def mag_case():
    """A JAX ``GraphSageSampler`` block ([4, 2] from 8 of 100 nodes) and
    its masked features, as ``tests/test_hetero.py`` builds them."""
    rng = np.random.default_rng(0)
    indptr = np.arange(0, 202, 2)
    indices = rng.integers(0, 100, 200)
    s = jqv.GraphSageSampler(jqv.CSRTopo(indptr=indptr, indices=indices),
                             [4, 2])
    n_id, _, adjs = s.sample(rng.choice(100, 8, replace=False))
    feat = rng.standard_normal((100, 12)).astype(np.float32)
    x = masked_feature_gather(jnp.asarray(feat), n_id)
    return dict(indptr=indptr, indices=indices, feat=feat, x=x, adjs=adjs)


def _port_adjs(jadjs):
    return [Adj(torch.from_numpy(np.array(a.edge_index)), None, a.size)
            for a in jadjs]


@pytest.mark.parametrize("variant", ["graphsage", "gat"])
class TestMAG240MGNN:
    def test_forward_equals_flax(self, mag_case, variant):
        c = mag_case
        fmodel = FlaxMAG(model=variant, hidden_dim=16, out_dim=5,
                         num_layers=2, dropout=0.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params = jax.jit(fmodel.init)(jax.random.key(0), c["x"],
                                          c["adjs"])
            want = np.asarray(jax.jit(fmodel.apply)(params, c["x"],
                                                    c["adjs"]))
        model = MAG240MGNN(variant, 12, 16, 5, 2, dropout=0.0)
        model.load_state_dict(mag_flax_to_state_dict(_tree_np(params)))
        with torch.no_grad():
            got = model(torch.from_numpy(np.array(c["x"])),
                        _port_adjs(c["adjs"])).numpy()
        assert got.shape == want.shape == (c["adjs"][-1].size[1], 5)
        assert np.isfinite(got[:8]).all()
        # LayerNorm's two variance formulas: the margin is 1e-4
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert _shapes(random_mag_flax_params(variant, 12, 16, 5, 2)) \
            == _shapes(params)

    def test_converters_round_trip(self, variant):
        rand = random_mag_flax_params(variant, 12, 16, 5, 2, heads=4,
                                      seed=1)
        model = MAG240MGNN(variant, 12, 16, 5, 2)
        model.load_state_dict(mag_flax_to_state_dict(rand))
        assert model.norms[0].eps == 1e-6
        _assert_trees_equal(mag_state_dict_to_flax(model.state_dict()),
                            rand)

    def test_forward_finite_through_the_port(self, mag_case, variant):
        """``tests/test_hetero.py::test_forward_finite`` through the
        port's ``GraphSageSampler``, and a train-mode step."""
        c = mag_case
        topo = CSRTopo(indptr=c["indptr"], indices=c["indices"],
                       device="cpu")
        n_id, bs, adjs = GraphSageSampler(topo, [4, 2], device="cpu") \
            .sample(np.random.default_rng(1).choice(100, 8, replace=False))
        feat = torch.from_numpy(c["feat"])
        x = feat[n_id.long().clamp(min=0)] * (n_id >= 0)[:, None]
        model = MAG240MGNN(variant, 12, 16, 5, 2, dropout=0.5)
        with torch.no_grad():
            out = model.eval()(x, adjs)
        assert out.shape == (adjs[-1].size[1], 5)
        assert torch.isfinite(out[:8]).all()
        gen = torch.Generator().manual_seed(0)
        loss = model.train()(x, adjs, generator=gen)[:bs].logsumexp(1).mean()
        loss.backward()
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
