"""The port's compaction, hop shapes and CSR container against the JAX
package's (``quiver_tpu/ops/sample.py``, ``pyg/sage_sampler.py``,
``utils/csr.py``): exact on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import sample as jsample
from quiver_tpu.pyg.sage_sampler import layer_shapes as jlayer_shapes
from quiver_tpu.utils import csr as jcsr
from quiver_tpu_torch.ops import sample
from quiver_tpu_torch.pyg import layer_shapes
from quiver_tpu_torch.utils import csr


def _eq(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def _layer_inputs(rng, s, k, n, holes):
    seeds = rng.choice(n, s, replace=False).astype(np.int32)
    if holes:                       # -1 holes inside the seed prefix
        seeds[rng.choice(s, s // 4, replace=False)] = -1
    else:                           # dense: -1 tail only
        seeds[s - s // 4:] = -1
    nbrs = rng.integers(0, n, (s, k)).astype(np.int32)
    nbrs[rng.random((s, k)) < 0.3] = -1
    nbrs[seeds < 0] = -1
    if s > 1 and seeds[0] >= 0:
        nbrs[0, :2] = seeds[1]      # a pick equal to another seed
    return seeds, nbrs


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("s,k,n", [(8, 3, 20), (40, 5, 1000), (1, 1, 5)])
def test_compact_layer_exact(rng, dense, s, k, n):
    seeds, nbrs = _layer_inputs(rng, s, k, n, holes=not dense)
    want = jsample.compact_layer(jnp.asarray(seeds), jnp.asarray(nbrs),
                                 seeds_dense=dense)
    got = sample.compact_layer(torch.from_numpy(seeds),
                               torch.from_numpy(nbrs), seeds_dense=dense)
    for f in ("n_id", "n_count", "row", "col", "edge_count"):
        _eq(getattr(got, f), getattr(want, f), f)


def test_compact_ids_exact(rng):
    ids = rng.integers(-1, 30, 64).astype(np.int32)
    want = jsample.compact_ids(jnp.asarray(ids))
    got = sample.compact_ids(torch.from_numpy(ids))
    for g, w, name in zip(got, want, ("n_id", "n_count", "local")):
        _eq(g, w, name)


def test_compact_all_invalid():
    seeds = np.full(4, -1, np.int32)
    nbrs = np.full((4, 2), -1, np.int32)
    got = sample.compact_layer(torch.from_numpy(seeds),
                               torch.from_numpy(nbrs), seeds_dense=True)
    assert int(got.n_count) == 0 and int(got.edge_count) == 0
    assert (got.n_id == -1).all() and (got.col == -1).all()


@pytest.mark.parametrize("bs,sizes", [(1024, [15, 10, 5]), (8, [4, 3, 2]),
                                      (3, [1])])
def test_layer_shapes_exact(bs, sizes):
    got = layer_shapes(bs, sizes)
    assert [tuple(x) for x in got] == [tuple(x) for x in
                                       jlayer_shapes(bs, sizes)]
    assert got[-1].n_id_cap == bs * np.prod([1 + k for k in sizes])


def test_csr_from_coo_exact(rng):
    n, e = 50, 400
    ei = rng.integers(0, n - 5, (2, e)).astype(np.int64)
    want = jcsr.get_csr_from_coo(jnp.asarray(ei), node_count=n)
    got = csr.get_csr_from_coo(torch.from_numpy(ei), node_count=n)
    for g, w, name in zip(got, want, ("indptr", "indices", "eid")):
        _eq(g, w, name)
    topo = csr.CSRTopo(edge_index=ei, node_count=n, device="cpu")
    jtopo = jcsr.CSRTopo(edge_index=jnp.asarray(ei), node_count=n)
    assert topo.node_count == jtopo.node_count == n
    assert topo.edge_count == jtopo.edge_count == e
    _eq(topo.degree, jtopo.degree, "degree")
    topo.feature_order = np.arange(n)[::-1].copy()
    assert topo.feature_order.dtype == torch.int32


def test_csr_from_arrays_and_index_dtype(rng):
    indptr = np.array([0, 2, 2, 5], np.int64)
    indices = np.array([1, 2, 0, 1, 2], np.int64)
    topo = csr.CSRTopo(indptr=indptr, indices=indices, device="cpu")
    assert topo.indptr.dtype == torch.int32
    assert topo.indices.dtype == torch.int32
    assert topo.degree.tolist() == [2, 0, 3]
    assert csr.index_dtype_for(2**31 - 1) == torch.int32
    assert csr.index_dtype_for(2**31) == torch.int64
    with pytest.raises(ValueError, match="edge_index or indptr"):
        csr.CSRTopo(device="cpu")
