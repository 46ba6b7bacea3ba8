"""The port's GraphSAGE against the JAX package's flax model
(``quiver_tpu/models/sage.py``) on parameters converted from flax.
Tolerance 1e-5: ``segment_sum`` and ``index_add_`` sum in different
orders, and flax's ``Dense`` and ``nn.Linear`` round their products
differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.models.sage import masked_mean_aggregate as jagg
from quiver_tpu.ops.sample import compact_layer as jcompact
from quiver_tpu.parallel.train import layers_to_adjs as jadjs
from quiver_tpu_torch.models import (GraphSAGE, flax_to_state_dict,
                                     masked_mean_aggregate,
                                     state_dict_to_flax)
from quiver_tpu_torch.models.convert import random_flax_params
from quiver_tpu_torch.ops.sample import compact_layer
from quiver_tpu_torch.parallel import layers_to_adjs

TOL = dict(atol=1e-5, rtol=1e-5)


def _walk(rng, bs, sizes, n):
    """A random frontier walk as numpy (seeds, per-hop picks)."""
    seeds = np.concatenate([rng.choice(n, bs - 2, replace=False),
                            [-1, -1]]).astype(np.int32)
    cur = jnp.asarray(seeds)
    hops = []
    for k in sizes:
        nbrs = rng.integers(0, n, (cur.shape[0], k)).astype(np.int32)
        nbrs[rng.random(nbrs.shape) < 0.3] = -1
        nbrs[np.asarray(cur) < 0] = -1
        hops.append(nbrs)
        cur = jcompact(cur, jnp.asarray(nbrs), seeds_dense=True).n_id
    return seeds, hops


def _both_layers(seeds, hops):
    jl, tl = [], []
    jc, tc = jnp.asarray(seeds), torch.from_numpy(seeds)
    for nbrs in hops:
        jl.append(jcompact(jc, jnp.asarray(nbrs), seeds_dense=True))
        tl.append(compact_layer(tc, torch.from_numpy(nbrs),
                                seeds_dense=True))
        jc, tc = jl[-1].n_id, tl[-1].n_id
    return jl, tl


@pytest.mark.parametrize("sizes", [[4, 3, 2], [3]])
def test_logits_from_converted_params(rng, sizes):
    bs, n, dim, hidden, out = 8, 300, 12, 16, 5
    seeds, hops = _walk(rng, bs, sizes, n)
    jl, tl = _both_layers(seeds, hops)
    cap = int(tl[-1].n_id.shape[0])
    x = rng.standard_normal((cap, dim)).astype(np.float32)
    fmodel = FlaxSAGE(hidden_dim=hidden, out_dim=out,
                      num_layers=len(sizes), dropout=0.0)
    jadj = jadjs(jl, bs, sizes)
    variables = fmodel.init(jax.random.key(0), jnp.asarray(x), jadj)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x), jadj))
    model = GraphSAGE(dim, hidden, out, len(sizes), dropout=0.0)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), layers_to_adjs(tl, bs, sizes))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_masked_mean_aggregate(rng):
    x = rng.standard_normal((20, 6)).astype(np.float32)
    ei = rng.integers(0, 7, (2, 40)).astype(np.int32)
    ei[:, rng.random(40) < 0.3] = -1
    want = np.asarray(jagg(jnp.asarray(x), jnp.asarray(ei), 7))
    got = masked_mean_aggregate(torch.from_numpy(x), torch.from_numpy(ei), 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_convert_round_trip():
    variables = random_flax_params(10, 16, 4, 3, seed=3)
    sd = flax_to_state_dict(variables)
    model = GraphSAGE(10, 16, 4, 3)
    model.load_state_dict(sd)                 # every key and shape fits
    back = state_dict_to_flax(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
    assert sd["convs.0.lin_root.weight"].shape == (16, 10)
    assert "convs.0.lin_nbr.bias" not in sd
