"""The port's fused hops and walk against the JAX package's Pallas
kernels (``quiver_tpu/ops/pallas/fused.py``), run as that package's own
tests run them: interpret mode with the portable ``"hash"`` PRNG. The
port's wrappers get CPU tensors, so they run the kernels' plain
versions; every output must match bit for bit."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import quant as jquant
from quiver_tpu.ops.pallas import fused as jfused
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import fused

K = 3
ROW_CAP = 16
DIM = 12
N = 300


@pytest.fixture(scope="module")
def graph():
    g = np.random.default_rng(1)
    deg = g.integers(0, 30, N)
    deg[:4] = 0                       # isolated nodes
    deg[4:8] = 25                     # degree above row_cap
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, N, indptr[-1]).astype(np.int32)
    featf = g.standard_normal((N, DIM)).astype(np.float32)
    perm = g.permutation(N).astype(np.int32)
    forder = np.empty(N, np.int32)
    forder[perm] = np.arange(N, dtype=np.int32)
    # 130 seeds: two 128-seed blocks with a ragged tail, -1 holes,
    # isolated and above-row_cap rows
    seeds = g.choice(np.arange(8, N), 130, replace=False).astype(np.int32)
    seeds[[0, 1, 2, 3]] = [0, 4, 5, 1]
    seeds[[10, 64, 129]] = -1
    return dict(indptr=indptr, indices=indices, featf=featf,
                forder=forder, seeds=seeds)


def _jax(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # JAX pads D=12 to 128 lanes
        return jax.device_get(fn(*args, **kw))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _feats(graph, kind):
    """(jax feat, port feat, jax forder, port forder, hot_rows)."""
    f = graph["featf"]
    if kind.startswith("int8"):
        jf = jquant.quantize(jnp.asarray(f), "int8")
        tf = quant.quantize(_t(f), "int8")
    else:
        jf, tf = jnp.asarray(f), _t(f)
    if kind.endswith("forder"):
        fo = graph["forder"]
        return jf, tf, jnp.asarray(fo), _t(fo), 200
    return jf, tf, None, None, None


def _bitwise(got, want, name):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), f"{name} differs from JAX"


def test_quantize_bit_exact(graph):
    jq = jquant.quantize(jnp.asarray(graph["featf"]), "int8")
    tq = quant.quantize(_t(graph["featf"]), "int8")
    for g, w, name in zip(tq, jq, ("data", "scale", "zero")):
        _bitwise(g, w, name)
    _bitwise(quant.dequantize(tq), jquant.dequantize(jq), "dequantize")
    ids = np.array([5, 0, 299, 5], np.int32)
    _bitwise(quant.gather_rows(tq, _t(ids)),
             jquant.gather_rows(jq, jnp.asarray(ids)), "gather_rows")
    assert quant.row_read_bytes(tq) == jquant.row_read_bytes(jq) == DIM + 8
    assert quant.tier_rows(tq) == N and quant.tier_dim(tq) == DIM
    assert quant.tier_dtype(tq) == torch.float32
    assert quant.tier_parts(_t(graph["featf"]))[1] is None


@pytest.mark.parametrize("seed", [7, -987654321])
def test_sample_hop_bit_exact(graph, seed):
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    want = _jax(jfused.fused_sample_hop, jnp.asarray(graph["indptr"]), idx,
                jnp.asarray(graph["seeds"]), K, jnp.int32(seed),
                row_cap=ROW_CAP, rng="hash", interpret=True)
    got = fused.fused_sample_hop(_t(graph["indptr"]), _t(graph["indices"]),
                                 _t(graph["seeds"]), K, seed,
                                 row_cap=ROW_CAP)
    _bitwise(got[0], want[0], "nbrs")
    _bitwise(got[1], want[1], "counts")
    counts = got[1].numpy()
    assert counts[0] == 0 and counts[10] == 0      # isolated, -1 seed
    assert counts[1] == K and (counts < K).any()


@pytest.mark.parametrize("kind", ["f32", "int8", "int8_forder",
                                  "f32_forder"])
def test_hot_hop_bit_exact(graph, kind):
    jf, tf, jfo, tfo, hot = _feats(graph, kind)
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    want = _jax(jfused.fused_hot_hop, jnp.asarray(graph["indptr"]), idx,
                jnp.asarray(graph["seeds"]), jf, K, jnp.int32(11),
                row_cap=ROW_CAP, rng="hash", interpret=True,
                feature_order=jfo, hot_rows=hot)
    got = fused.fused_hot_hop(_t(graph["indptr"]), _t(graph["indices"]),
                              _t(graph["seeds"]), tf, K, 11,
                              row_cap=ROW_CAP, feature_order=tfo,
                              hot_rows=hot)
    for g, w, name in zip(got, want, ("nbrs", "counts", "seed_rows",
                                      "pick_rows")):
        _bitwise(g, w, name)
    if hot is not None:                 # some pick really fell cold
        nb = got[0].numpy().reshape(-1)
        cold = (nb >= 0) & (graph["forder"][np.clip(nb, 0, N - 1)] >= hot)
        assert cold.any()
        assert not got[3].numpy()[cold].any()


def _hop_seeds(key, hops):
    return [int(jfused._hop_seed(key, i)) for i in range(hops)]


@pytest.mark.parametrize("kind", ["int8", "f32_forder"])
def test_multihop_bit_exact(graph, kind):
    sizes = [4, 3, 2]
    jf, tf, jfo, tfo, hot = _feats(graph, kind)
    seeds = np.concatenate([graph["seeds"][1:6], [-1, -1, -1]]) \
        .astype(np.int32)
    key = jax.random.key(2)
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    jn, jl, jx = _jax(jfused.fused_multihop, jnp.asarray(graph["indptr"]),
                      idx, jnp.asarray(seeds), jf, sizes, key,
                      row_cap=ROW_CAP, rng="hash", interpret=True,
                      feature_order=jfo, hot_rows=hot)
    hs = _hop_seeds(key, len(sizes))
    args = (_t(graph["indptr"]), _t(graph["indices"]), _t(seeds), tf,
            sizes, hs)
    n_id, layers, x = fused.fused_multihop(
        *args, row_cap=ROW_CAP, feature_order=tfo, hot_rows=hot)
    _bitwise(n_id, jn, "n_id")
    assert len(layers) == len(jl) == len(sizes)
    for lay, ref in zip(layers, jl):
        for f in ("n_id", "n_count", "row", "col", "edge_count"):
            _bitwise(getattr(lay, f), getattr(ref, f), f)
    valid = n_id.numpy() >= 0
    assert x.shape == jx.shape and x.dtype == torch.float32
    assert x.numpy()[valid].tobytes() == np.asarray(jx)[valid].tobytes()
    assert not x.numpy()[~valid].any()
    # the plain walk and the split walk (one lookup over the final
    # frontier each) agree too
    for walk in (fused.multihop_plain, fused.fused_multihop_reference):
        rn, rl, rx = walk(*args, row_cap=ROW_CAP, feature_order=tfo,
                          hot_rows=hot)
        assert torch.equal(rn, n_id)
        assert rx.numpy()[valid].tobytes() == x.numpy()[valid].tobytes()


@pytest.mark.parametrize("kind,isolated", [
    ("int8", False), ("f32", False), ("int8_forder", False),
    ("f32", True)])
def test_multihop_x_bit_exact_with_positive_zero_padding(graph, kind,
                                                         isolated):
    """``fused_multihop``'s ``x`` (seed rows written into ``x[:n]`` by the
    leaf hop, pick rows scattered) against the JAX walk's on every valid
    row, bit for bit, and every padding row +0.0 by its bits: the
    features have negative values, so a masked row written into the
    padding would leave -0.0 there. With isolated seeds no pick fills
    the leaf's -1 seed slots, which stay padding."""
    sizes = [3, 2]
    jf, tf, jfo, tfo, hot = _feats(graph, kind)
    first = [0, 1, 2, 3] if isolated else graph["seeds"][:7]
    seeds = np.concatenate([first, [-1, -1, -1]]).astype(np.int32)
    key = jax.random.key(8)
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    jn, _, jx = _jax(jfused.fused_multihop, jnp.asarray(graph["indptr"]),
                     idx, jnp.asarray(seeds), jf, sizes, key,
                     row_cap=ROW_CAP, rng="hash", interpret=True,
                     feature_order=jfo, hot_rows=hot)
    n_id, _, x = fused.fused_multihop(
        _t(graph["indptr"]), _t(graph["indices"]), _t(seeds), tf, sizes,
        _hop_seeds(key, len(sizes)), row_cap=ROW_CAP, feature_order=tfo,
        hot_rows=hot)
    _bitwise(n_id, jn, "n_id")
    valid = n_id.numpy() >= 0
    assert (~valid).any()
    assert x.numpy()[valid].tobytes() == np.asarray(jx)[valid].tobytes()
    assert not x.view(torch.int32).numpy()[~valid].any()


@pytest.mark.parametrize("kind", ["f32", "int8_forder"])
def test_hot_hop_seed_rows_out(graph, kind):
    """With ``seed_rows_out`` the valid seeds' rows land in the given
    (row-strided) block and the slots of -1 seeds keep their bits; the
    other outputs are those of the call without it."""
    _, tf, _, tfo, hot = _feats(graph, kind)
    args = (_t(graph["indptr"]), _t(graph["indices"]), _t(graph["seeds"]),
            tf, K, 21)
    kw = dict(row_cap=ROW_CAP, feature_order=tfo, hot_rows=hot)
    block = torch.full((130, DIM + 4), -7.5)
    out = block[:, :DIM]
    got = fused.fused_hot_hop(*args, seed_rows_out=out, **kw)
    want = fused.fused_hot_hop(*args, **kw)
    assert got[2] is out
    valid = _t(graph["seeds"]) >= 0
    _bitwise(out[valid], want[2][valid].numpy(), "seed_rows")
    assert (out[~valid] == -7.5).all() and (block[:, DIM:] == -7.5).all()
    for g, w, name in zip(got[:2] + got[3:], want[:2] + want[3:],
                          ("nbrs", "counts", "pick_rows")):
        _bitwise(g, w.numpy(), name)


@pytest.mark.parametrize("kind", ["int8", "f32_forder"])
def test_hot_hop_reference_bit_exact(graph, kind):
    """The split hop (sampling layer, then the plain lookup) against the
    JAX package's, and against the fused hop: the acceptance gate."""
    jf, tf, jfo, tfo, hot = _feats(graph, kind)
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    want = _jax(jfused.fused_hot_hop_reference,
                jnp.asarray(graph["indptr"]), idx,
                jnp.asarray(graph["seeds"]), jf, K, jnp.int32(-13),
                row_cap=ROW_CAP, rng="hash", interpret=True,
                feature_order=jfo, hot_rows=hot)
    args = (_t(graph["indptr"]), _t(graph["indices"]), _t(graph["seeds"]),
            tf, K, -13)
    kw = dict(row_cap=ROW_CAP, feature_order=tfo, hot_rows=hot)
    got = fused.fused_hot_hop_reference(*args, **kw)
    fused_out = fused.fused_hot_hop(*args, **kw)
    for g, w, f, name in zip(got, want, fused_out,
                             ("nbrs", "counts", "seed_rows", "pick_rows")):
        _bitwise(g, w, name)
        _bitwise(f, w, name)


@pytest.mark.parametrize("kind", ["int8", "f32_forder"])
def test_multihop_reference_bit_exact(graph, kind):
    """The split walk against the JAX package's, every output and every
    slot of ``x``; the plain walk equals both."""
    sizes = [4, 3, 2]
    jf, tf, jfo, tfo, hot = _feats(graph, kind)
    seeds = np.concatenate([graph["seeds"][6:12], [-1, -1]]) \
        .astype(np.int32)
    key = jax.random.key(5)
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    jn, jl, jx = _jax(jfused.fused_multihop_reference,
                      jnp.asarray(graph["indptr"]), idx, jnp.asarray(seeds),
                      jf, sizes, key, row_cap=ROW_CAP, rng="hash",
                      interpret=True, feature_order=jfo, hot_rows=hot)
    args = (_t(graph["indptr"]), _t(graph["indices"]), _t(seeds), tf,
            sizes, _hop_seeds(key, len(sizes)))
    kw = dict(row_cap=ROW_CAP, feature_order=tfo, hot_rows=hot)
    for walk in (fused.fused_multihop_reference, fused.multihop_plain):
        n_id, layers, x = walk(*args, **kw)
        _bitwise(n_id, jn, "n_id")
        assert len(layers) == len(jl) == len(sizes)
        for lay, ref in zip(layers, jl):
            for f in ("n_id", "n_count", "row", "col", "edge_count"):
                _bitwise(getattr(lay, f), getattr(ref, f), f)
        _bitwise(x, jx, "x")


def test_sample_multihop_bit_exact(graph):
    sizes = [3, 2]
    seeds = graph["seeds"][:8].copy()
    key = jax.random.key(6)
    idx = jfused.pad_indices(jnp.asarray(graph["indices"]), ROW_CAP)
    jn, jl = _jax(jfused.fused_sample_multihop,
                  jnp.asarray(graph["indptr"]), idx, jnp.asarray(seeds),
                  sizes, key, row_cap=ROW_CAP, rng="hash", interpret=True)
    n_id, layers = fused.fused_sample_multihop(
        _t(graph["indptr"]), _t(graph["indices"]), _t(seeds), sizes,
        _hop_seeds(key, len(sizes)), row_cap=ROW_CAP)
    _bitwise(n_id, jn, "n_id")
    for lay, ref in zip(layers, jl):
        _bitwise(lay.col, ref.col, "col")
        _bitwise(lay.row, ref.row, "row")


def test_empty_graph_walk():
    indptr = torch.zeros(51, dtype=torch.int32)
    indices = torch.zeros(0, dtype=torch.int32)
    feat = torch.from_numpy(
        np.random.default_rng(0).standard_normal((50, DIM))
        .astype(np.float32))
    seeds = torch.tensor([3, 9, -1, -1], dtype=torch.int32)
    n_id, layers, x = fused.fused_multihop(indptr, indices, seeds, feat,
                                           [3, 2], [1, 2])
    nid = n_id.numpy()
    assert set(nid[nid >= 0]) == {3, 9}
    for lay in layers:
        assert not (lay.col >= 0).any()
    assert torch.equal(x[n_id >= 0], feat[n_id[n_id >= 0].long()])


def test_wrappers_refuse_what_the_kernel_does_not_take(graph):
    ip, ix = _t(graph["indptr"]), _t(graph["indices"])
    seeds = _t(graph["seeds"])
    feat = _t(graph["featf"])
    with pytest.raises(ValueError, match="int32"):
        fused.fused_sample_hop(ip.long(), ix, seeds, K, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_sample_hop(ip, ix, _t(np.repeat(graph["seeds"], 2))[::2],
                               K, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="row_cap"):
        fused.fused_sample_hop(ip, ix, seeds, ROW_CAP + 1, 1,
                               row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="fp32"):
        fused.fused_hot_hop(ip, ix, seeds, feat.double(), K, 1,
                            row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="seed_rows_out"):
        fused.fused_hot_hop(ip, ix, seeds, feat, K, 1, row_cap=ROW_CAP,
                            seed_rows_out=torch.zeros(seeds.shape[0],
                                                      DIM + 1))
    with pytest.raises(ValueError, match="one seed per hop"):
        fused.fused_multihop(ip, ix, seeds, feat, [2, 2], [1])


def test_cpu_tensors_take_the_plain_version(graph):
    fused.reset_launches()
    fused.fused_hot_hop(_t(graph["indptr"]), _t(graph["indices"]),
                        _t(graph["seeds"]), _t(graph["featf"]), K, 3,
                        row_cap=ROW_CAP)
    fused.fused_hot_hop_reference(_t(graph["indptr"]), _t(graph["indices"]),
                                  _t(graph["seeds"]), _t(graph["featf"]), K,
                                  3, row_cap=ROW_CAP)
    assert fused.LAUNCHES == {"fused_sample_hop": 0, "fused_hot_hop": 0,
                              "sample_layer": 0, "gather_rows": 0,
                              "gather_elems": 0, "gather_rows_sharded": 0}
