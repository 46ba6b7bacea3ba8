"""The port's GAT (``quiver_tpu_torch/models/gat.py``, its converters in
``models/convert.py``) against the JAX package's flax GAT
(``quiver_tpu/models/gat.py``), alone and through the train and serve
steps.

Tolerances: ``segment_softmax`` within 1e-6 (``index_add_`` and
``segment_sum`` sum in different orders); the forward within 1e-5 from
parameters flax's ``init`` made (flax's ``Dense`` and ``nn.Linear``
round their products differently); the fused train step's loss within
1e-5 and its parameters after two Adam steps within 1e-6 absolute
(``lr`` 1e-3), against JAX's ``build_train_step(fused_hot_hop=True)`` in
interpret mode with the ``"hash"`` PRNG, the port given the hop seeds
JAX derives from its key and dropout 0 on both sides (the two dropout
streams differ); the fused engine's logits within 1e-5 of JAX's
``ServeEngine``. Then the weighted configuration's own path on the CPU:
``GraphSageSampler(edge_weight=...)``, the masked gather and
``build_split_train_step``'s ``step_fn``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu.models import GAT as FlaxGAT
from quiver_tpu.models import gat as jgat
from quiver_tpu.ops import sample as jsample
from quiver_tpu.ops.pallas.fused import _hop_seed
from quiver_tpu.parallel import train as jtrain
from quiver_tpu.serving import ServeEngine as JServeEngine
from quiver_tpu_torch import GAT, CSRTopo, GraphSageSampler, ServeEngine
from quiver_tpu_torch.models import (gat_flax_to_state_dict,
                                     gat_state_dict_to_flax,
                                     random_gat_flax_params, segment_softmax)
from quiver_tpu_torch.parallel import (build_split_train_step,
                                       build_train_step, init_state,
                                       masked_feature_gather)
from quiver_tpu_torch.pyg import Adj

N, DIM, HIDDEN, HEADS, OUT = 300, 12, 8, 2, 5
ROW_CAP = 16
BS = 8
LR = 1e-3
SIZES = [3, 2]
TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # JAX pads D=12 to 128 lanes
        return jax.device_get(fn(*args, **kw))


@pytest.fixture(scope="module")
def data():
    g = np.random.default_rng(11)
    deg = g.integers(0, 30, N)
    deg[:3] = 0                       # isolated nodes
    deg[3:6] = 25                     # degree above row_cap
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, N, indptr[-1]).astype(np.int32)
    feat = g.standard_normal((N, DIM)).astype(np.float32)
    seeds = np.concatenate([[0, 4], g.choice(np.arange(6, N), 4,
                                             replace=False),
                            [-1, -1]]).astype(np.int32)
    labels = g.integers(0, OUT, BS).astype(np.int32)
    # one sampled block (JAX's exact sampler) for the model-level tests
    cur, layers = jnp.asarray(seeds), []
    key = jax.random.key(4)
    for i, k in enumerate(SIZES):
        nbrs, _ = jsample.sample_layer(jnp.asarray(indptr),
                                       jnp.asarray(indices), cur, k,
                                       jax.random.fold_in(key, i))
        layers.append(jsample.compact_layer(cur, nbrs, seeds_dense=i > 0))
        cur = layers[-1].n_id
    n_id = np.asarray(cur)
    x = feat[np.maximum(n_id, 0)] * (n_id >= 0)[:, None]
    jadjs = jtrain.layers_to_adjs(layers, BS, SIZES)
    return dict(indptr=indptr, indices=indices, feat=feat, seeds=seeds,
                labels=labels, x=x.astype(np.float32), jadjs=jadjs)


def _port_adjs(jadjs):
    return [Adj(_t(a.edge_index), None, a.size) for a in jadjs]


def _flax(data, dropout=0.0):
    fmodel = FlaxGAT(hidden_dim=HIDDEN, out_dim=OUT, num_layers=len(SIZES),
                     heads=HEADS, dropout=dropout)
    variables = fmodel.init(jax.random.key(0), jnp.asarray(data["x"]),
                            data["jadjs"])
    return fmodel, variables


def _port(variables, dropout=0.0):
    model = GAT(DIM, HIDDEN, OUT, len(SIZES), heads=HEADS, dropout=dropout)
    model.load_state_dict(gat_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    return model


def _assert_params(model, jparams):
    got = gat_state_dict_to_flax(model.state_dict())["params"]
    want = jax.tree_util.tree_map(np.asarray, jparams)["params"]
    assert got.keys() == want.keys()
    for conv, leaves in want.items():
        for name, w in leaves.items():
            if isinstance(w, dict):
                w, g = w["kernel"], got[conv][name]["kernel"]
            else:
                g = got[conv][name]
            np.testing.assert_allclose(g, w, err_msg=f"{conv}.{name}",
                                       **PARAM_TOL)


def test_segment_softmax_matches_jax():
    """Segments with valid edges, one whose edges are all masked, empty
    ones, and masked edges pointing at segment 0; 1-D and per-head."""
    g = np.random.default_rng(0)
    e, t = 40, 9
    logits = (g.standard_normal((e, 3)) * 5).astype(np.float32)
    seg = g.integers(0, 6, e).astype(np.int32)        # 6, 7, 8 empty
    valid = g.random(e) > 0.3
    valid[seg == 4] = False                           # all masked
    seg[~valid & (g.random(e) > 0.5)] = 0
    for h in range(3):
        want = jgat.segment_softmax(jnp.asarray(logits[:, h]),
                                    jnp.asarray(seg), t, jnp.asarray(valid))
        got = segment_softmax(_t(logits[:, h]), _t(seg), t, _t(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    both = segment_softmax(_t(logits), _t(seg), t, _t(valid)[:, None])
    assert (both[seg == 4] == 0).all() and (both[~valid] == 0).all()
    for h in range(3):
        np.testing.assert_allclose(
            both[:, h].numpy(),
            segment_softmax(_t(logits[:, h]), _t(seg), t, _t(valid)).numpy(),
            atol=1e-7)
    sums = np.zeros((t, 3))
    np.add.at(sums, seg[valid], both.numpy()[valid])
    live = np.isin(np.arange(t), seg[valid])
    np.testing.assert_allclose(sums[live], 1.0, atol=1e-6)


def test_forward_matches_flax(data):
    fmodel, variables = _flax(data)
    want = fmodel.apply(variables, jnp.asarray(data["x"]), data["jadjs"])
    model = _port(variables).eval()
    with torch.no_grad():
        got = model(_t(data["x"]), _port_adjs(data["jadjs"]))
    assert got.shape == (BS, OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_converters_round_trip_and_random_params(data):
    _, variables = _flax(data)
    flat = jax.tree_util.tree_map(np.asarray, variables)
    back = gat_state_dict_to_flax(gat_flax_to_state_dict(flat))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(flat)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(flat)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rand = random_gat_flax_params(DIM, HIDDEN, OUT, len(SIZES),
                                  heads=HEADS, seed=3)
    assert jax.tree_util.tree_structure(rand) == \
        jax.tree_util.tree_structure(flat)
    for a, b in zip(jax.tree_util.tree_leaves(rand),
                    jax.tree_util.tree_leaves(flat)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the draws' scales: lecun-normal kernels, glorot-uniform attention
    big = random_gat_flax_params(256, 64, 47, 2, heads=4, seed=0)["params"]
    k = big["conv0"]["lin_src"]["kernel"]
    assert abs(k.std() * np.sqrt(256) - 1.0) < 0.05 and \
        np.abs(k).max() <= 2 * np.sqrt(1 / 256) / 0.8796 + 1e-6
    att = big["conv0"]["att_src"]
    assert np.abs(att).max() <= np.sqrt(6 / (4 + 64))
    model = GAT(256, 64, 47, 2, heads=4)
    model.load_state_dict(gat_flax_to_state_dict({"params": big}))


def test_padding_invariance(data):
    """Appending masked edges and padded source rows leaves every
    target's logits as they were."""
    _, variables = _flax(data)
    model = _port(variables).eval()
    adjs = _port_adjs(data["jadjs"])
    x = _t(data["x"])
    padded = []
    for a in adjs:
        pad = torch.full((2, 7), -1, dtype=a.edge_index.dtype)
        pad[1, :3] = 0                       # masked by their source
        padded.append(Adj(torch.cat([a.edge_index, pad], 1), None,
                          (a.size[0] + 5, a.size[1])))
    # the outer hop's sources gain 5 rows nobody points at
    xp = torch.cat([x[:adjs[0].size[0]], torch.randn(5, DIM),
                    x[adjs[0].size[0]:]])
    with torch.no_grad():
        want = model(x, adjs)
        got = model(xp, padded)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_dropout_from_the_generator_in_train_mode_only(data):
    _, variables = _flax(data)
    model = _port(variables, dropout=0.5)
    x, adjs = _t(data["x"]), _port_adjs(data["jadjs"])
    gen = lambda s: torch.Generator().manual_seed(s)
    model.train()
    a, b = model(x, adjs, gen(1)), model(x, adjs, gen(1))
    assert torch.equal(a, b)
    assert not torch.equal(a, model(x, adjs, gen(2)))
    model.eval()
    c = model(x, adjs, gen(1))
    assert torch.equal(c, model(x, adjs, gen(2)))
    assert not torch.equal(a, c)


def _hop_seeds(key, hops):
    return [int(_hop_seed(key, i)) for i in range(hops)]


def test_fused_train_step_matches_jax(data):
    fmodel, variables = _flax(data)
    tx = optax.adam(LR)
    jstate = jtrain.TrainState(variables, tx.init(variables),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.build_train_step(
        fmodel, tx, SIZES, BS, fused_hot_hop=True, fused_row_cap=ROW_CAP,
        fused_rng="hash", fused_interpret=True, donate=False)
    model = _port(variables)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = build_train_step(model, opt, SIZES, BS, fused_hot_hop=True,
                            fused_row_cap=ROW_CAP)
    state = init_state(model, opt)
    graph = [data["indptr"], data["indices"], data["seeds"], data["labels"]]
    jg, tg = [jnp.asarray(a) for a in graph], [_t(a) for a in graph]
    jfeat, feat = jnp.asarray(data["feat"]), _t(data["feat"])
    for i, seed in enumerate((42, 43)):
        key = jax.random.key(seed)
        jstate, jloss = _jax(jstep, jstate, jfeat, None, *jg, key)
        state, loss = step(state, feat, None, *tg,
                           _hop_seeds(key, len(SIZES)), seed)
        assert state.step == i + 1
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
        _assert_params(state.model, jstate.params)


def test_fused_engine_matches_jax_engine(data):
    fmodel, variables = _flax(data)
    topo = (data["indptr"], data["indices"])
    jeng = JServeEngine(fmodel, variables, topo, data["feat"], [SIZES], BS,
                        fused_hot_hop=True, fused_row_cap=ROW_CAP, seed=5)
    ids = np.array([3, 7, 11, 250, 0, 42], np.int32)
    want = np.asarray(_jax(jeng.run, ids))
    _, sub = jax.random.split(jax.random.key(5))
    eng = ServeEngine(GAT(DIM, HIDDEN, OUT, len(SIZES), heads=HEADS),
                      gat_flax_to_state_dict(jax.tree_util.tree_map(
                          np.asarray, variables)),
                      CSRTopo(indptr=data["indptr"], indices=data["indices"],
                              device="cpu"),
                      data["feat"], [SIZES], BS, fused_hot_hop=True,
                      fused_row_cap=ROW_CAP, device="cpu")
    got = eng.run(ids, hop_seeds=_hop_seeds(sub, len(SIZES)))
    np.testing.assert_allclose(got[:6].numpy(), want[:6], **TOL)
    assert torch.isfinite(eng.run(ids)).all()


def test_weighted_sampler_trains_gat():
    """The weighted configuration's path (``examples/gat_weighted.py``):
    ``GraphSageSampler(edge_weight=..., sampling=...)`` with the example's
    refresh weights, the masked gather, ``build_split_train_step``'s
    ``step_fn``, on a planted graph (every neighbour of a node shares its
    class, which the features carry: GAT has no self term, so only a
    label its neighbours carry can be learnt). Over twelve steps the
    mean of the last four losses falls below 0.7 of the first four's."""
    g = np.random.default_rng(3)
    labels = g.integers(0, OUT, N)
    src = g.integers(0, N, 3000)
    by_class = [np.flatnonzero(labels == c) for c in range(OUT)]
    dst = np.array([g.choice(by_class[labels[v]]) for v in src])
    topo = CSRTopo(edge_index=np.stack([src, dst]), node_count=N,
                   device="cpu")
    deg = np.diff(topo.indptr.numpy())
    w = 0.5 + deg[topo.indices.numpy()] / deg.max()
    centers = g.standard_normal((OUT, DIM)).astype(np.float32)
    feat = _t(centers[labels] + 0.5 * g.standard_normal((N, DIM))
              .astype(np.float32))
    for sampling in ("exact", "rotation"):
        torch.manual_seed(0)
        model = GAT(DIM, HIDDEN, OUT, 2, heads=HEADS, dropout=0.0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        _, step_fn = build_split_train_step(model, opt, [5, 3], 32)
        sampler = GraphSageSampler(topo, [5, 3], device="cpu",
                                   edge_weight=w, sampling=sampling)
        state, losses = init_state(model, opt), []
        for it in range(12):
            seeds = g.choice(N, 32, replace=False).astype(np.int32)
            n_id, bs, adjs = sampler.sample(seeds)
            x = masked_feature_gather(feat, n_id)
            state, loss = step_fn(state, x, adjs, _t(labels[seeds]), it)
            losses.append(loss.item())
        assert np.isfinite(losses).all()
        assert np.mean(losses[-4:]) < 0.7 * np.mean(losses[:4]), losses
