"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA card with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``."""

import numpy as np
import pytest
import torch

from quiver_tpu_torch import CSRTopo, GraphSAGE, ServeEngine
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import fused, gather, sample_kernel

pytestmark = pytest.mark.cuda

N, DIM, K, ROW_CAP = 3000, 20, 4, 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def graph(card):
    g = np.random.default_rng(0)
    deg = g.integers(0, 60, N)
    deg[:10] = 0
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, N, indptr[-1]).astype(np.int32)
    seeds = g.choice(N, 1000, replace=False).astype(np.int32)
    seeds[::37] = -1
    seeds[1] = 3
    feat = g.standard_normal((N, DIM)).astype(np.float32)
    perm = g.permutation(N).astype(np.int32)
    on = lambda a: torch.from_numpy(a).to(card)
    return dict(indptr=on(indptr), indices=on(indices), seeds=on(seeds),
                feat=on(feat), forder=on(perm))


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def test_sample_hop_kernel_equals_plain(graph):
    args = (graph["indptr"], graph["indices"], graph["seeds"], K, -77,
            ROW_CAP)
    before = fused.LAUNCHES["fused_sample_hop"]
    got = fused.fused_sample_hop(*args)
    assert fused.LAUNCHES["fused_sample_hop"] == before + 1
    want = fused.sample_hop_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["int8", "fp32", "int8_forder"])
def test_hot_hop_kernel_equals_plain(graph, kind):
    feat = quant.quantize(graph["feat"], "int8") \
        if kind.startswith("int8") else graph["feat"]
    fo, hot = (graph["forder"], N // 2) if "forder" in kind else (None, None)
    args = (graph["indptr"], graph["indices"], graph["seeds"], feat, K, 5,
            ROW_CAP, fo, hot)
    got = fused.fused_hot_hop(*args)
    want = fused.hot_hop_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


def test_sample_layer_kernel_equals_plain_and_fused_hop(graph):
    args = (graph["indptr"], graph["indices"], graph["seeds"], K, -77,
            ROW_CAP)
    before = fused.LAUNCHES["sample_layer"]
    got = sample_kernel.sample_layer_kernel(*args)
    assert fused.LAUNCHES["sample_layer"] == before + 1
    want = sample_kernel.sample_layer_plain(*args)
    hop = fused.fused_sample_hop(*args)
    for g, w, h in zip(got, want, hop):
        assert torch.equal(g, w) and torch.equal(g, h)
    torch.cuda.synchronize()


# (dtype, width): one case for each word the kernel copies in
@pytest.mark.parametrize("dtype,dim,word", [
    (torch.float32, DIM, 16), (torch.bfloat16, DIM, 4),
    (torch.float16, 3, 2), (torch.int8, 7, 1)])
def test_gather_rows_kernel_equals_plain(graph, dtype, dim, word):
    feat = (graph["feat"][:, :dim] * 20).to(dtype).contiguous()
    ids = graph["seeds"][graph["seeds"] >= 0].contiguous()
    before = fused.LAUNCHES["gather_rows"]
    got = gather.gather_rows(feat, ids)
    assert fused.LAUNCHES["gather_rows"] == before + 1
    assert gather.word_bytes(feat, got) == word
    want = gather.gather_rows_plain(feat, ids)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(got, torch.index_select(feat, 0, ids))
    torch.cuda.synchronize()


def test_split_walk_equals_fused_walk(graph):
    feat = quant.quantize(graph["feat"], "int8")
    # dense: distinct valid ids, then a -1 tail
    seeds = torch.cat([graph["seeds"][2:30],
                       torch.full((4,), -1, dtype=torch.int32,
                                  device=graph["seeds"].device)])
    args = (graph["indptr"], graph["indices"], seeds, feat, [4, 3, 2],
            [5, -6, 7], ROW_CAP)
    fused.reset_launches()
    rn, rl, rx = fused.fused_multihop_reference(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"fused_sample_hop": 0, "fused_hot_hop": 0,
                              "sample_layer": 3, "gather_rows": 0}
    n_id, layers, x = fused.fused_multihop(*args)
    assert torch.equal(n_id, rn)
    for a, b in zip(layers, rl):
        assert torch.equal(a.row, b.row) and torch.equal(a.col, b.col)
    valid = n_id >= 0
    assert torch.equal(_bits(x[valid]), _bits(rx[valid]))


def test_engine_serves_through_the_kernels(graph):
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    eng = ServeEngine(GraphSAGE(DIM, 16, 5, 2), None, topo,
                      quant.quantize(graph["feat"], "int8"), [[4, 3]], 64,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP)
    fused.reset_launches()
    out = eng.run(torch.arange(40, dtype=torch.int32))
    torch.cuda.synchronize()
    assert out.shape == (64, 5) and torch.isfinite(out).all()
    assert fused.LAUNCHES == {"fused_sample_hop": 1, "fused_hot_hop": 1,
                              "sample_layer": 0, "gather_rows": 0}
