"""The port's train steps (``quiver_tpu_torch/parallel/train.py``)
against the JAX package's (``quiver_tpu/parallel/train.py``), and the
port's exact sampler (``ops/sample.py: sample_layer``,
``ops/sample_multihop.py``) held by contract.

The fused step is compared with JAX's ``build_train_step(fused_hot_hop=
True)`` run as its own tests run it (interpret mode, ``"hash"`` PRNG),
each hop seed being the one JAX derives from its key; dropout is 0 on
both sides, since the two dropout streams differ. Tolerances: the loss
within 1e-5 (``segment_sum`` and ``index_add_`` sum in different orders,
flax's ``Dense`` and ``nn.Linear`` round their products differently);
parameters after two Adam steps within ``PARAM_TOL``, 1e-6 absolute
with ``lr`` 1e-3: Adam divides each gradient by
its own root mean square, so a float difference of a gradient carries
into the update as a relative one."""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops import quant as jquant
from quiver_tpu.ops import sample as jsample
from quiver_tpu.ops.pallas import fused as jfused
from quiver_tpu.parallel import train as jtrain
from quiver_tpu_torch import GraphSAGE, quantize
from quiver_tpu_torch.models import flax_to_state_dict, state_dict_to_flax
from quiver_tpu_torch.models.sage import dropout
from quiver_tpu_torch.ops import sample
from quiver_tpu_torch.ops.sample_multihop import sample_multihop
from quiver_tpu_torch.parallel import (build_split_train_step,
                                       build_train_step, draw_step_seeds,
                                       init_state, layers_to_adjs)
from quiver_tpu_torch.pyg.sage_sampler import Adj

N, DIM, HIDDEN, OUT = 300, 12, 16, 5
ROW_CAP = 16
BS = 8
LR = 1e-3
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


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
    return dict(indptr=indptr, indices=indices, feat=feat, seeds=seeds,
                labels=labels)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # JAX pads D=12 to 128 lanes
        return jax.device_get(fn(*args, **kw))


def _flax(sizes):
    """A flax GraphSAGE, its variables and ``optax.adam(LR)`` state,
    shaped for the ladder's static frontier budgets."""
    fmodel = FlaxSAGE(hidden_dim=HIDDEN, out_dim=OUT, num_layers=len(sizes),
                      dropout=0.0)
    layers, cur = [], jnp.full((BS,), -1, jnp.int32)
    for k in sizes:
        layers.append(jsample.compact_layer(
            cur, jnp.full((cur.shape[0], k), -1, jnp.int32),
            seeds_dense=True))
        cur = layers[-1].n_id
    tx = optax.adam(LR)
    state = jtrain.init_state(fmodel, tx, jnp.zeros((cur.shape[0], DIM)),
                              jtrain.layers_to_adjs(layers, BS, sizes),
                              jax.random.key(0))
    return fmodel, tx, state


def _port(state, sizes, **kw):
    """The port's model and Adam on the same parameters, and its step."""
    model = GraphSAGE(DIM, HIDDEN, OUT, len(sizes), dropout=0.0)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params)))
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = build_train_step(model, opt, sizes, BS, **kw)
    return init_state(model, opt), step


def _feats(data, kind):
    if kind == "int8":
        return (jquant.quantize(jnp.asarray(data["feat"]), "int8"),
                quantize(data["feat"], "int8"))
    return jnp.asarray(data["feat"]), _t(data["feat"])


def _assert_params(model, jparams):
    got = state_dict_to_flax(model.state_dict())["params"]
    want = jax.tree_util.tree_map(np.asarray, jparams)["params"]
    for conv, lins in want.items():
        for lin, leaves in lins.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got[conv][lin][leaf], w,
                                           err_msg=f"{conv}.{lin}.{leaf}",
                                           **PARAM_TOL)


def _hop_seeds(key, hops):
    return [int(jfused._hop_seed(key, i)) for i in range(hops)]


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("sizes", [[4], [3, 2]])
def test_fused_step_matches_jax(data, sizes, kind):
    fmodel, tx, jstate = _flax(sizes)
    jstep = jtrain.build_train_step(
        fmodel, tx, sizes, BS, fused_hot_hop=True, fused_row_cap=ROW_CAP,
        fused_rng="hash", fused_interpret=True, donate=False)
    state, step = _port(jstate, sizes, fused_hot_hop=True,
                        fused_row_cap=ROW_CAP)
    jfeat, feat = _feats(data, kind)
    graph = [data["indptr"], data["indices"], data["seeds"], data["labels"]]
    jg, tg = [jnp.asarray(a) for a in graph], [_t(a) for a in graph]
    for i, seed in enumerate((42, 43)):
        key = jax.random.key(seed)
        jstate, jloss = _jax(jstep, jstate, jfeat, None, jg[0], jg[1],
                             jg[2], jg[3], key)
        state, loss = step(state, feat, None, tg[0], tg[1], tg[2], tg[3],
                           _hop_seeds(key, len(sizes)), dropout_seed=seed)
        assert state.step == i + 1 and loss.dim() == 0
        assert not loss.requires_grad
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
        _assert_params(state.model, jstate.params)


def test_three_hops_match_the_jax_split_oracle(data):
    """``[2, 2, 2]`` against the JAX package's split oracle
    (``fused_multihop_reference``, then ``masked_feature_gather``) under
    ``value_and_grad`` and ``optax.adam``, over two steps."""
    sizes = [2, 2, 2]
    fmodel, tx, jstate = _flax(sizes)
    state, step = _port(jstate, sizes, fused_hot_hop=True,
                        fused_row_cap=ROW_CAP)
    jfeat, feat = _feats(data, "int8")
    indptr, indices = jnp.asarray(data["indptr"]), jnp.asarray(
        data["indices"])
    seeds, labels = jnp.asarray(data["seeds"]), jnp.asarray(data["labels"])

    @jax.jit
    def oracle(jstate, key):
        n_id, layers, _ = jfused.fused_multihop_reference(
            indptr, jfused.pad_indices(indices, ROW_CAP), seeds, jfeat,
            sizes, key, row_cap=ROW_CAP, rng="hash", interpret=True)
        x = jtrain.masked_feature_gather(jfeat, n_id, None)
        adjs = jtrain.layers_to_adjs(layers, BS, sizes)

        def loss_of(p):
            logits = fmodel.apply(p, x, adjs, train=True,
                                  rngs={"dropout": key})
            return jtrain.cross_entropy_logits(logits[:BS], labels)

        loss, grads = jax.value_and_grad(loss_of)(jstate.params)
        updates, opt = tx.update(grads, jstate.opt_state, jstate.params)
        return jtrain.TrainState(optax.apply_updates(jstate.params, updates),
                                 opt, jstate.step + 1), loss

    for seed in (42, 43):
        key = jax.random.key(seed)
        jstate, jloss = _jax(oracle, jstate, key)
        state, loss = step(state, feat, None, _t(data["indptr"]),
                           _t(data["indices"]), _t(data["seeds"]),
                           _t(data["labels"]), _hop_seeds(key, 3), seed)
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
        _assert_params(state.model, jstate.params)


def _port_adjs(jadjs):
    return [Adj(_t(a.edge_index), None, a.size) for a in jadjs]


def test_split_step_matches_jax(data):
    """``build_split_train_step``'s ``step_fn`` against JAX's on the same
    ``x`` and ``adjs`` (sampled by JAX), over two steps; then the port's
    own ``sample_fn``."""
    sizes = [3, 2]
    fmodel, tx, jstate = _flax(sizes)
    jsample_fn, jstep_fn = jtrain.build_split_train_step(
        fmodel, tx, sizes, BS, donate=False)
    model = GraphSAGE(DIM, HIDDEN, OUT, len(sizes), dropout=0.0)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    sample_fn, step_fn = build_split_train_step(model, opt, sizes, BS)
    state = init_state(model, opt)
    labels = jnp.asarray(data["labels"])
    for seed in (42, 43):
        key = jax.random.key(seed)
        n_id, jadjs = _jax(jsample_fn, jnp.asarray(data["indptr"]),
                           jnp.asarray(data["indices"]),
                           jnp.asarray(data["seeds"]), key)
        x = jtrain.masked_feature_gather(jnp.asarray(data["feat"]),
                                         jnp.asarray(n_id))
        jstate, jloss = _jax(jstep_fn, jstate, x, jadjs, labels, key)
        state, loss = step_fn(state, _t(x), _port_adjs(jadjs),
                              _t(data["labels"]), seed)
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
        _assert_params(model, jstate.params)
    assert state.step == 2

    ip, ix, sd = (_t(data[k]) for k in ("indptr", "indices", "seeds"))
    n_id, adjs = sample_fn(ip, ix, sd, 5)
    n2, adjs2 = sample_fn(ip, ix, sd, 5)
    assert torch.equal(n_id, n2)
    assert [a.size for a in adjs] == [tuple(a.size) for a in jadjs]
    for a, b in zip(adjs, adjs2):
        assert torch.equal(a.edge_index, b.edge_index)
    assert torch.equal(n_id[:6], sd[:6])       # valid seeds keep slots


def test_split_route_of_the_train_step(data):
    """``build_train_step(fused_hot_hop=False)``: the exact sampler seeded
    with ``hop_seeds[0]``, the masked gather, the same loss; equal to the
    stages of ``build_split_train_step`` on the same seeds."""
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    state, step = _port(jstate, sizes)
    model2 = copy.deepcopy(state.model)
    opt2 = torch.optim.Adam(model2.parameters(), lr=LR)
    sample_fn, step_fn = build_split_train_step(model2, opt2, sizes, BS)
    ip, ix, sd, lb = (_t(data[k]) for k in ("indptr", "indices", "seeds",
                                            "labels"))
    feat = _t(data["feat"])
    _, loss = step(state, feat, None, ip, ix, sd, lb, [77, 78], 9)
    n_id, adjs = sample_fn(ip, ix, sd, 77)
    x = feat[n_id.long().clamp(min=0)] * (n_id >= 0)[:, None]
    _, loss2 = step_fn(init_state(model2, opt2), x, adjs, lb, 9)
    assert torch.isfinite(loss) and loss.item() == loss2.item()
    for a, b in zip(state.model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("budget", [2, 64])
def test_split_route_dedup_gather(data, budget):
    """``dedup_gather`` on the split route: the unique gather (budget 64
    holds the frontier's unique ids) or its overflow fallback (budget 2)
    gives the masked gather's rows, so the same loss and update."""
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    args = [_t(data[k]) for k in ("feat", "indptr", "indices", "seeds",
                                  "labels")]
    args.insert(1, None)
    results = []
    for kw in ({}, {"dedup_gather": budget}):
        state, step = _port(jstate, sizes, **kw)
        state, loss = step(state, *args, [77, 78], 9)
        results.append((loss, list(state.model.parameters())))
    (loss, params), (dloss, dparams) = results
    assert torch.isfinite(loss) and loss.item() == dloss.item()
    for a, b in zip(params, dparams):
        assert torch.equal(a, b)


def test_knob_validation():
    """Mirrors ``test_fused.py::TestFusedTrainStep::test_knob_validation``,
    plus the pieces that are later work and the step's own checks."""
    model = GraphSAGE(DIM, HIDDEN, OUT, 2)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    assert callable(build_train_step(model, opt, [4, 4], 8,
                                     fused_hot_hop=True))
    with pytest.raises(ValueError, match="at least one hop"):
        build_train_step(model, opt, [], 8, fused_hot_hop=True)
    for sizes in ([4], [4, 4]):
        with pytest.raises(ValueError, match="exact"):
            build_train_step(model, opt, sizes, 8, fused_hot_hop=True,
                             method="rotation")
    with pytest.raises(ValueError, match="dedup_gather"):
        build_train_step(model, opt, [4], 8, fused_hot_hop=True,
                         dedup_gather=True)
    assert callable(build_train_step(model, opt, [4], 8, dedup_gather=True))
    # collect_metrics is ported (tests/test_torch_metrics.py)
    assert callable(build_train_step(model, opt, [4], 8, fused_hot_hop=True,
                                     collect_metrics=True))
    # the windowed methods build on the split route (their steps are
    # driven in test_windowed_train_steps); the fused walk refuses them
    # and the layout knobs, as in JAX
    for build in (build_train_step, build_split_train_step):
        assert all(callable(f) for f in np.atleast_1d(
            build(model, opt, [4, 4], 8, method="window")))
        with pytest.raises(ValueError, match="unknown sampling method"):
            build(model, opt, [4, 4], 8, method="walk")
    for kw in (dict(indices_stride=128), dict(hub_frac=0.1)):
        with pytest.raises(ValueError, match="indices_stride nor hub_frac"):
            build_train_step(model, opt, [4], 8, fused_hot_hop=True, **kw)

    step = build_train_step(model, opt, [2, 2], 8, fused_hot_hop=True)
    ip = torch.tensor([0, 1, 2], dtype=torch.int32)
    ix = torch.tensor([1, 0], dtype=torch.int32)
    sd = torch.tensor([0, 1] + [-1] * 6, dtype=torch.int32)
    args = (torch.zeros(2, DIM), None, ip, ix, sd,
            torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="one seed per hop"):
        step(init_state(model, opt), *args, [1], 0)
    other = torch.optim.Adam(model.parameters(), lr=LR)
    with pytest.raises(ValueError, match="built with"):
        step(init_state(model, other), *args, [1, 2], 0)


def test_dropout_is_seeded_and_train_only(data):
    g = np.random.default_rng(2)
    x = _t(g.standard_normal((400, DIM)).astype(np.float32))
    gen = lambda s: torch.Generator().manual_seed(s)
    a, b, c = (dropout(x, 0.5, gen(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.4 < kept.float().mean() < 0.6
    assert torch.equal(a[kept], x[kept] / 0.5)
    assert dropout(x, 0.0, gen(1)) is x
    assert not dropout(x, 1.0).any()

    sizes = [3, 2]
    seeds = _t(data["seeds"])
    layers, cur = [], seeds
    for i, k in enumerate(sizes):
        nbrs = torch.randint(0, N, (cur.shape[0], k), generator=gen(i),
                             dtype=torch.int32)
        nbrs[cur < 0] = -1
        layers.append(sample.compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    adjs = layers_to_adjs(layers, BS, sizes)
    xb = _t(data["feat"])[layers[-1].n_id.long().clamp(min=0)]
    model = GraphSAGE(DIM, HIDDEN, OUT, 2, dropout=0.5)
    with torch.no_grad():
        train = [model(xb, adjs, generator=gen(s)) for s in (3, 3, 4)]
        model.eval()
        ev = [model(xb, adjs, generator=gen(s)) for s in (3, 4)]
        ev.append(model(xb, adjs))
    assert torch.equal(train[0], train[1])
    assert not torch.equal(train[0], train[2])
    assert torch.equal(ev[0], ev[1]) and torch.equal(ev[0], ev[2])
    assert not torch.equal(ev[0], train[0])

    # the step: one dropout_seed gives one loss, another seed another
    model.train()
    losses = []
    for ds in (5, 5, 6):
        m = copy.deepcopy(model)
        opt = torch.optim.Adam(m.parameters(), lr=LR)
        step = build_train_step(m, opt, sizes, BS, fused_hot_hop=True,
                                fused_row_cap=ROW_CAP)
        _, loss = step(init_state(m, opt), _t(data["feat"]), None,
                       _t(data["indptr"]), _t(data["indices"]), seeds,
                       _t(data["labels"]), [1, 2], ds)
        losses.append(loss.item())
    assert losses[0] == losses[1] != losses[2]


def test_draw_step_seeds():
    hs, ds = draw_step_seeds(torch.Generator().manual_seed(3), 3)
    want = torch.randint(-2**31, 2**31 - 1, (4,),
                         generator=torch.Generator().manual_seed(3))
    assert hs + [ds] == want.tolist()
    assert all(-2**31 <= v < 2**31 for v in hs + [ds])


# -- the exact sampler, held by contract ---------------------------------------


@pytest.mark.parametrize("k", [1, 4, 30])
def test_sample_layer_contract(data, k):
    ip, ix = data["indptr"], data["indices"]
    seeds = np.concatenate([np.arange(0, 40), [-1, 5, -1]]).astype(np.int32)
    nbrs, counts, slots = sample.sample_layer(
        _t(ip), _t(ix), _t(seeds), k, torch.Generator().manual_seed(k),
        with_slots=True)
    nbrs, counts, slots = nbrs.numpy(), counts.numpy(), slots.numpy()
    deg = np.where(seeds >= 0, ip[seeds + 1] - ip[seeds], 0)
    np.testing.assert_array_equal(counts, np.minimum(deg, k))
    for r, s in enumerate(seeds):
        c = counts[r]
        assert (nbrs[r, c:] == -1).all() and (slots[r, c:] == -1).all()
        if c == 0:
            continue
        sl = slots[r, :c]
        assert len(set(sl.tolist())) == c                  # distinct
        assert (sl >= ip[s]).all() and (sl < ip[s + 1]).all()
        np.testing.assert_array_equal(nbrs[r, :c], ix[sl])  # membership


def test_sample_layer_on_an_empty_graph():
    ip = torch.zeros(6, dtype=torch.int32)
    ix = torch.zeros(0, dtype=torch.int32)
    sd = torch.tensor([3, 1, -1], dtype=torch.int32)
    n_id, layers = sample_multihop(ip, ix, sd, [2, 2],
                                   torch.Generator().manual_seed(0))
    assert n_id.tolist()[:2] == [3, 1] and (n_id[2:] == -1).all()
    assert all(int(lay.edge_count) == 0 for lay in layers)


def test_sample_layer_uniform():
    """Every position of a degree-10 row is drawn equally often, and so
    is every unordered pair (chi-square, fixed seed)."""
    deg, k, reps = 10, 3, 6000
    ip = torch.tensor([0, deg], dtype=torch.int32)
    ix = torch.arange(deg, dtype=torch.int32)
    nbrs, counts = sample.sample_layer(
        ip, ix, torch.zeros(reps, dtype=torch.int32), k,
        torch.Generator().manual_seed(1234))
    assert (counts == k).all()
    pos = np.bincount(nbrs.numpy().ravel(), minlength=deg)
    assert stats.chisquare(pos).pvalue > 1e-3
    srt = np.sort(nbrs.numpy(), axis=1)
    pairs = np.concatenate([srt[:, [0, 1]], srt[:, [0, 2]], srt[:, [1, 2]]])
    pc = np.bincount(pairs[:, 0] * deg + pairs[:, 1], minlength=deg * deg)
    pc = pc.reshape(deg, deg)[np.triu_indices(deg, 1)]
    assert stats.chisquare(pc).pvalue > 1e-3


def test_sample_multihop_compaction_matches_jax(data):
    """The port's multi-hop layers equal the JAX package's compaction of
    the same picks (the same generator stream replayed hop by hop)."""
    sizes = [4, 3]
    ip, ix, sd = (_t(data[k]) for k in ("indptr", "indices", "seeds"))
    n_id, layers = sample_multihop(ip, ix, sd, sizes,
                                   torch.Generator().manual_seed(8),
                                   seeds_dense=True)
    gen = torch.Generator().manual_seed(8)
    cur = jnp.asarray(data["seeds"])
    for k, lay in zip(sizes, layers):
        nbrs, _ = sample.sample_layer(ip, ix, _t(cur), k, gen)
        want = jsample.compact_layer(cur, jnp.asarray(nbrs.numpy()),
                                     seeds_dense=True)
        for f in ("n_id", "n_count", "row", "col", "edge_count"):
            np.testing.assert_array_equal(getattr(lay, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        cur = want.n_id
    assert torch.equal(n_id, layers[-1].n_id)
    assert n_id.shape[0] == BS * 5 * 4


def test_sample_multihop_refuses_later_variants(data):
    """Weighted sampling runs (the pool draw, also under a windowed
    method without rows views; tests/test_torch_weighted.py), as do the
    rotation, window, rows-view and edge-id knobs
    (tests/test_torch_sampler.py), and the collector, which counts the
    final frontier (tests/test_torch_metrics.py)."""
    ip, ix, sd = (_t(data[k]) for k in ("indptr", "indices", "seeds"))
    gen = torch.Generator().manual_seed(0)
    deg = np.diff(data["indptr"])
    valid = data["seeds"] >= 0
    for kw in (dict(edge_weight=torch.ones(ix.shape[0])),
               dict(edge_weight=torch.ones(ix.shape[0]), method="window")):
        _, layers = sample_multihop(ip, ix, sd, [2], gen, **kw)
        want = np.minimum(deg[data["seeds"][valid]], 2).sum()
        assert int(layers[0].edge_count) == want
    from quiver_tpu_torch import metrics
    col = metrics.Collector()
    n_id, _ = sample_multihop(ip, ix, sd, [2], gen, collector=col)
    vec = col.counters()
    assert int(vec[metrics.FRONTIER_VALID]) == int((n_id >= 0).sum())
    assert int(vec[metrics.FRONTIER_CAP]) == n_id.shape[0]


# -- the windowed methods through the steps ------------------------------------

def _windowed_rows(data, gen, overlap=False):
    ix = _t(data["indices"])
    rids = sample.edge_row_ids(_t(data["indptr"]), ix.shape[0])
    permuted = sample.permute_csr(ix, rids, gen)
    if overlap:
        return sample.as_index_rows_overlapping(permuted), 128
    return sample.as_index_rows(permuted), None


@pytest.mark.parametrize("method", ["rotation", "window"])
def test_windowed_step_requires_rows(data, method):
    """JAX's ``_check_rows`` ``TypeError`` without ``indices_rows``; the
    fused walk refuses a rows view as JAX's ``_fused_loss`` does."""
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    state, step = _port(jstate, sizes, method=method)
    args = [_t(data[k]) for k in ("feat", "indptr", "indices", "seeds",
                                  "labels")]
    args.insert(1, None)
    with pytest.raises(TypeError) as want:
        jtrain._check_rows(method, None, "train")
    with pytest.raises(TypeError) as got:
        step(state, *args, [1, 2], 0)
    assert str(got.value) == str(want.value)
    fstate, fstep = _port(jstate, sizes, fused_hot_hop=True,
                          fused_row_cap=ROW_CAP)
    with pytest.raises(TypeError, match="does not take indices_rows"):
        fstep(fstate, *args, [1, 2], 0, sample.as_index_rows(args[3]))


@pytest.mark.parametrize("overlap", [False, True])
def test_exact_rows_view_gives_the_scattered_loss(data, overlap):
    """``method="exact"`` with a rows view of the un-shuffled indices and
    ``hub_frac`` (the wide-exact read) trains bit for bit as the
    scattered route: the wide draw is ``sample_layer``'s."""
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    ix = _t(data["indices"])
    rows = sample.as_index_rows_overlapping(ix) if overlap \
        else sample.as_index_rows(ix)
    frac = sample.exact_bucket_meta(_t(data["indptr"])).frac
    args = [_t(data[k]) for k in ("feat", "indptr", "indices", "seeds",
                                  "labels")]
    args.insert(1, None)
    results = []
    for kw, extra in (({}, ()),
                      (dict(hub_frac=frac,
                            indices_stride=128 if overlap else None),
                       (rows,))):
        state, step = _port(jstate, sizes, **kw)
        for i in range(2):
            state, loss = step(state, *args, [77 + i, 5], 9, *extra)
        results.append((loss, list(state.model.parameters())))
    (loss, params), (wloss, wparams) = results
    assert torch.isfinite(loss) and loss.item() == wloss.item()
    for a, b in zip(params, wparams):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method,overlap", [("rotation", False),
                                            ("rotation", True),
                                            ("window", False)])
def test_windowed_train_steps(data, method, overlap):
    """Rotation and window through ``build_train_step`` (the reshuffled
    rows view passed last) give the loss and update of
    ``build_split_train_step``'s stages on the same seeds, and the
    sampled block holds the pick contract: every edge a graph edge,
    ``min(deg, k)`` of them per valid target of each hop."""
    sizes = [3, 2]
    _, _, jstate = _flax(sizes)
    rows, stride = _windowed_rows(data, torch.Generator().manual_seed(5),
                                  overlap)
    state, step = _port(jstate, sizes, method=method,
                        indices_stride=stride)
    model2 = copy.deepcopy(state.model)
    opt2 = torch.optim.Adam(model2.parameters(), lr=LR)
    sample_fn, step_fn = build_split_train_step(
        model2, opt2, sizes, BS, method=method, indices_stride=stride)
    ip, ix, sd, lb = (_t(data[k]) for k in ("indptr", "indices", "seeds",
                                            "labels"))
    feat = _t(data["feat"])
    _, loss = step(state, feat, None, ip, ix, sd, lb, [77, 78], 9, rows)
    n_id, adjs = sample_fn(ip, ix, sd, 77, rows)
    x = feat[n_id.long().clamp(min=0)] * (n_id >= 0)[:, None]
    _, loss2 = step_fn(init_state(model2, opt2), x, adjs, lb, 9)
    assert torch.isfinite(loss) and loss.item() == loss2.item()
    for a, b in zip(state.model.parameters(), model2.parameters()):
        assert torch.equal(a, b)

    indptr, indices = data["indptr"], data["indices"]
    nsets = [set(indices[indptr[v]:indptr[v + 1]].tolist())
             for v in range(N)]
    nid = n_id.numpy()
    n_valid = int((data["seeds"] >= 0).sum())   # hop 0's targets
    for adj, k in zip(adjs[::-1], sizes):
        src, dst = adj.edge_index.numpy()
        m = src >= 0
        assert all(u in nsets[t] for t, u in zip(nid[dst[m]], nid[src[m]]))
        per = np.bincount(dst[m], minlength=adj.size[1])
        deg = np.diff(indptr)[nid[:n_valid]]
        np.testing.assert_array_equal(per[:n_valid], np.minimum(deg, k))
        assert not per[n_valid:].any()
        n_valid = max(n_valid, int(src[m].max()) + 1)
