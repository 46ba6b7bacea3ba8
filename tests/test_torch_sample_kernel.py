"""The port's sampling layer (``quiver_tpu_torch/ops/kernels/
sample_kernel.py``) against the JAX package's Pallas kernel
``sample_layer_pallas``, run as that package's tests run it: interpret
mode with the portable ``"hash"`` PRNG. The port's wrapper gets CPU
tensors, so it runs the kernel's plain version; every output must match
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops.pallas import sample_kernel as jsk
from quiver_tpu_torch.ops.kernels import _build, fused, sample_kernel

K = 3
ROW_CAP = 16
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
    # 130 seeds: two 128-seed blocks with a ragged tail, -1 holes,
    # isolated and above-row_cap rows
    seeds = g.choice(np.arange(8, N), 130, replace=False).astype(np.int32)
    seeds[[0, 1, 2, 3]] = [0, 4, 5, 1]
    seeds[[10, 64, 129]] = -1
    return dict(indptr=indptr, indices=indices, seeds=seeds)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_layer(graph, k, seed, row_cap=ROW_CAP):
    idx = jsk.pad_indices(jnp.asarray(graph["indices"]), row_cap)
    return jax.device_get(jsk.sample_layer_pallas(
        jnp.asarray(graph["indptr"]), idx, jnp.asarray(graph["seeds"]), k,
        jnp.int32(seed), row_cap=row_cap, rng="hash", interpret=True))


def _args(graph):
    return _t(graph["indptr"]), _t(graph["indices"]), _t(graph["seeds"])


@pytest.mark.parametrize("seed", [7, -987654321])
def test_sample_layer_bit_exact(graph, seed):
    want = _jax_layer(graph, K, seed)
    got = sample_kernel.sample_layer_kernel(*_args(graph), K, seed,
                                            row_cap=ROW_CAP)
    for g, w, name in zip(got, want, ("nbrs", "counts")):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        assert g.numpy().tobytes() == w.tobytes(), f"{name} differs"
    counts = got[1].numpy()
    assert counts[0] == 0 and counts[10] == 0 and counts[129] == 0
    assert counts[1] == K and (counts < K).any()
    nbrs = got[0].numpy()
    assert (nbrs[counts == 0] == -1).all()


def test_rows_above_row_cap_draw_from_their_first_row_cap(graph):
    """k = row_cap: a row of degree 25 yields 16 distinct picks, all from
    its first 16 entries, and matches the JAX kernel."""
    want = _jax_layer(graph, ROW_CAP, 3)
    got = sample_kernel.sample_layer_kernel(*_args(graph), ROW_CAP, 3,
                                            row_cap=ROW_CAP)
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()
    ip, ix = graph["indptr"], graph["indices"]
    for slot, node in ((1, 4), (2, 5)):
        head = ix[ip[node]:ip[node] + ROW_CAP]
        picks = got[0].numpy()[slot]
        assert sorted(picks.tolist()) == sorted(head.tolist())


@pytest.mark.parametrize("seed", [7, -987654321])
def test_sample_layer_equals_fused_sample_hop(graph, seed):
    got = sample_kernel.sample_layer_kernel(*_args(graph), K, seed,
                                            row_cap=ROW_CAP)
    want = fused.fused_sample_hop(*_args(graph), K, seed, row_cap=ROW_CAP)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_seed_is_taken_as_int32(graph):
    a = sample_kernel.sample_layer_kernel(*_args(graph), K, 2**32 - 5,
                                          row_cap=ROW_CAP)
    b = sample_kernel.sample_layer_kernel(*_args(graph), K, -5,
                                          row_cap=ROW_CAP)
    assert torch.equal(a[0], b[0])


def test_graph_with_no_nodes_gives_degree_zero():
    indptr = torch.zeros(1, dtype=torch.int32)
    indices = torch.zeros(0, dtype=torch.int32)
    seeds = torch.tensor([0, 5, -1], dtype=torch.int32)
    start, deg = sample_kernel._seed_rows(indptr, seeds)
    assert not start.any() and not deg.any()
    nbrs, counts = sample_kernel.sample_layer_kernel(indptr, indices, seeds,
                                                     2, 9, row_cap=4)
    assert not counts.any() and (nbrs == -1).all()
    assert nbrs.shape == (3, 2) and nbrs.dtype == torch.int32


def test_tpu_stream_is_not_ported(graph):
    with pytest.raises(ValueError, match="hash"):
        sample_kernel.sample_layer_kernel(*_args(graph), K, 1,
                                          row_cap=ROW_CAP, rng="tpu")


def test_wrapper_refuses_what_the_kernel_does_not_take(graph):
    ip, ix, seeds = _args(graph)
    layer = sample_kernel.sample_layer_kernel
    with pytest.raises(ValueError, match="int32"):
        layer(ip.long(), ix, seeds, K, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="int32"):
        layer(ip, ix, seeds.long(), K, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="contiguous"):
        layer(ip, ix, _t(np.repeat(graph["seeds"], 2))[::2], K, 1,
              row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="row_cap"):
        layer(ip, ix, seeds, ROW_CAP + 1, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="row_cap"):
        layer(ip, ix, seeds, 0, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="on cpu"):      # devices differ
        layer(ip.to("meta"), ix, seeds, K, 1, row_cap=ROW_CAP)
    with pytest.raises(ValueError, match="cuda or cpu"):
        layer(ip.to("meta"), ix.to("meta"), seeds.to("meta"), K, 1,
              row_cap=ROW_CAP)


def test_cpu_tensors_take_the_plain_version(graph):
    _build.reset_launches()
    sample_kernel.sample_layer_kernel(*_args(graph), K, 3, row_cap=ROW_CAP)
    assert _build.LAUNCHES["sample_layer"] == 0
