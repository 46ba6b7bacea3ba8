"""The port's multi-rank train steps (``build_dist_train_step`` in
``quiver_tpu_torch/parallel/dist.py``, ``build_e2e_train_step`` in
``quiver_tpu_torch/parallel/train.py``) on H gloo ranks (one
``RankPool`` of 4 for the module, with a subgroup of the first 2).

Held:
- the dist step, whose rows come through the exchange, against the
  port's data-parallel step over the whole table on the same seeds and
  streams: equal losses and parameters, bit for bit, over two Adam steps
  with dropout 0.5 (both average gradients by the same ``all_reduce``),
  for the dense and compact exchanges, an int8 store, replicated nodes
  and the rotation sampler (JAX pins the same parity at rtol 1e-5,
  ``tests/test_dist_train.py``);
- the dist step's loss falls over 8 steps;
- the data-parallel fused step against JAX's ``build_e2e_train_step
  (fused_hot_hop=True)`` in interpret mode with the ``"hash"`` PRNG, on
  the hop seeds JAX derives for each shard: the mean loss within 1e-5,
  and the gradients within 1e-5 (read as the parameter change of one
  SGD step at learning rate 1); dropout 0 on both sides, whose streams
  differ;
- ``rank_step_seeds``: distinct per rank, the same on a replay.
Every call into the pool has a time limit (the pool's), and every
collective the group's 60 s timeout."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chip_smoke import RankPool
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops.pallas.fused import _hop_seed
from quiver_tpu.ops.sample import compact_layer as jcompact
from quiver_tpu.parallel import build_e2e_train_step as jbuild_e2e
from quiver_tpu.parallel import train as jtrain
from quiver_tpu_torch import (DistFeature, GraphSAGE, PartitionInfo,
                              TorchComm, metrics, quantize)
from quiver_tpu_torch.models import flax_to_state_dict
from quiver_tpu_torch.ops import as_index_rows, edge_row_ids, permute_csr
from quiver_tpu_torch.parallel import (build_dist_train_step,
                                       build_e2e_train_step, init_state,
                                       rank_step_seeds)

N, DIM, HIDDEN, CLASSES = 240, 12, 16, 4
SIZES = [3, 2]
B = 8                                  # seeds per rank
ROW_CAP = 16
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, subgroups=(2,), timeout=60, call_timeout=120) as p:
        yield p


@pytest.fixture(scope="module")
def world():
    """``tests/test_dist_train.py``'s ``setup`` graph: n 240, D 12,
    4 classes, degrees 1-8; labels learnable from the features (the
    argmax of a fixed projection)."""
    rng = np.random.default_rng(0)
    deg = rng.integers(1, 9, N)
    indptr = np.zeros(N + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    labels = np.argmax(feat @ rng.standard_normal((DIM, CLASSES)),
                       axis=1).astype(np.int32)
    return dict(indptr=indptr, indices=indices, feat=feat, labels=labels)


def _g2h(h):
    rng = np.random.default_rng(h)
    g2h = rng.integers(0, h, N).astype(np.int32)
    g2h[:h] = np.arange(h)
    return g2h


def _seeds(h, seed):
    return np.random.default_rng(seed).choice(N, h * B, replace=False) \
        .astype(np.int32)


def _flax_state(tx):
    fmodel = FlaxSAGE(hidden_dim=HIDDEN, out_dim=CLASSES, num_layers=2,
                      dropout=0.0)
    layers, cur = [], jnp.full((B,), -1, jnp.int32)
    for k in SIZES:
        layers.append(jcompact(cur, jnp.full((cur.shape[0], k), -1,
                                             jnp.int32), seeds_dense=True))
        cur = layers[-1].n_id
    state = jtrain.init_state(fmodel, tx, jnp.zeros((cur.shape[0], DIM)),
                              jtrain.layers_to_adjs(layers, B, SIZES),
                              jax.random.key(1))
    return fmodel, state


def _params(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


# -- the rank side ------------------------------------------------------------


def _model(state_dict, dropout):
    torch.manual_seed(0)
    model = GraphSAGE(DIM, HIDDEN, CLASSES, 2, dropout=dropout)
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    return model


def _rank_dist_vs_e2e(ctx, h, w, g2h, case, steps):
    group = ctx.groups[h]
    if group is None:
        return None
    policy, cap, rep, method = case
    info = PartitionInfo(host=ctx.rank, hosts=h, global2host=g2h,
                         replicate=rep)
    dist = DistFeature.from_partition(
        w["feat"], info, TorchComm(ctx.rank, h, group=group),
        dtype_policy=policy, device="cpu")
    table = quantize(w["feat"], policy)
    indptr = torch.from_numpy(w["indptr"])
    indices = torch.from_numpy(w["indices"])
    rows = None
    if method == "rotation":
        rows = as_index_rows(permute_csr(
            indices, edge_row_ids(indptr, indices.shape[0]),
            torch.Generator().manual_seed(3)))
    init = _params(_model(None, 0.5))
    steps_fns, states = [], []
    for kind in ("dist", "e2e"):
        model = _model(init, 0.5)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        if kind == "dist":
            fn = build_dist_train_step(
                model, opt, SIZES, B, group, dist._rows_per_host,
                method=method, with_replicate=rep is not None,
                exchange_cap=cap)
        else:
            fn = build_e2e_train_step(model, opt, SIZES, B, group,
                                      method=method)
        steps_fns.append(fn)
        states.append(init_state(model, opt))
    losses = [[], []]
    for it in range(steps):
        seeds_all = _seeds(h, it)
        mine = seeds_all[ctx.rank * B:(ctx.rank + 1) * B]
        seeds = torch.from_numpy(mine)
        labels = torch.from_numpy(w["labels"][mine])
        hops, drop = rank_step_seeds(100 + it, ctx.rank, len(SIZES))
        states[0], loss = steps_fns[0](
            states[0], dist.shard, dist._g2h, dist._g2l, indptr, indices,
            seeds, labels, hops, drop, indices_rows=rows,
            rep_args=dist._rep_args or ())
        losses[0].append(loss)
        states[1], loss = steps_fns[1](
            states[1], table, None, indptr, indices, seeds, labels, hops,
            drop, indices_rows=rows)
        losses[1].append(loss)
    return ([torch.stack(x) for x in losses],
            [_params(s.model) for s in states])


def _rank_trains(ctx, h, w, g2h, steps):
    group = ctx.groups[h]
    if group is None:
        return None
    info = PartitionInfo(host=ctx.rank, hosts=h, global2host=g2h)
    dist = DistFeature.from_partition(
        w["feat"], info, TorchComm(ctx.rank, h, group=group),
        dtype_policy="int8", device="cpu")
    model = _model(None, 0.0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = build_dist_train_step(model, opt, SIZES, B, group,
                                 dist._rows_per_host, exchange_cap=True,
                                 collect_metrics=True, merge_counters=True)
    state = init_state(model, opt)
    mine = _seeds(h, 0)[ctx.rank * B:(ctx.rank + 1) * B]
    losses, counters = [], None
    for it in range(steps):
        hops, drop = rank_step_seeds(it, ctx.rank, len(SIZES))
        state, loss, counters = step(
            state, dist.shard, dist._g2h, dist._g2l,
            torch.from_numpy(w["indptr"]), torch.from_numpy(w["indices"]),
            torch.from_numpy(mine), torch.from_numpy(w["labels"][mine]),
            hops, drop)
        losses.append(float(loss))
    return losses, counters


def _rank_e2e_fused(ctx, h, w, state_dict, seeds_all, labels_all, hop_seeds,
                    adam):
    """The fused data-parallel step from JAX's weights, one step of SGD
    at learning rate 1 or one step per hop-seed list of a fresh
    ``Adam(1e-3)`` (``optax.adam``'s counterpart): the losses and the
    parameters after."""
    group = ctx.groups[h]
    if group is None:
        return None
    model = _model(state_dict, 0.0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8) if adam else \
        torch.optim.SGD(model.parameters(), lr=1.0)
    step = build_e2e_train_step(model, opt, SIZES, B, group,
                                fused_hot_hop=True, fused_row_cap=ROW_CAP)
    sl = slice(ctx.rank * B, (ctx.rank + 1) * B)
    state, losses = init_state(model, opt), []
    for hs in hop_seeds:
        state, loss = step(state, torch.from_numpy(w["feat"]), None,
                           torch.from_numpy(w["indptr"]),
                           torch.from_numpy(w["indices"]),
                           torch.from_numpy(seeds_all[sl]),
                           torch.from_numpy(labels_all[sl]), hs[ctx.rank], 0)
        losses.append(loss)
    return torch.stack(losses), _params(model)


# -- the tests ----------------------------------------------------------------

REP = np.array([3, 77, 140], np.int32)
CASES = {"dense": (None, None, None, "exact"),
         "compact": (None, 24, None, "exact"),
         "cap_true": (None, True, None, "exact"),
         "int8": ("int8", None, None, "exact"),
         "int8_compact": ("int8", 24, None, "exact"),
         "replicate": (None, None, REP, "exact"),
         "replicate_compact": (None, 24, REP, "exact"),
         "rotation": (None, None, None, "rotation")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("h", [2, 4])
def test_dist_step_equals_e2e_step(pool, world, h, case):
    res = pool.run(_rank_dist_vs_e2e, h, world, _g2h(h), CASES[case], 2)[:h]
    for losses, params in res:
        np.testing.assert_array_equal(losses[0], losses[1])
        np.testing.assert_array_equal(losses[0], res[0][0][0])
        for name in params[0]:
            np.testing.assert_array_equal(params[0][name], params[1][name])
            np.testing.assert_array_equal(params[0][name],
                                          res[0][1][0][name])
        assert np.isfinite(losses[0]).all()


def test_dist_step_trains(pool, world):
    losses, counters = pool.run(_rank_trains, 4, world, _g2h(4), 8)[0]
    assert losses[-1] < 0.8 * losses[0], losses
    # the group's merged counters: one exchange a rank, the frontier's
    # fill summed over the ranks
    assert counters.shape == (metrics.NUM_COUNTERS,)
    assert counters[metrics.EXCH_CALLS] == 4
    assert 0 < counters[metrics.FRONTIER_VALID] <= \
        counters[metrics.FRONTIER_CAP]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_e2e_fused_step_matches_jax(pool, world, opt):
    """SGD at learning rate 1: one step, whose parameter change is the
    mean gradient; Adam(1e-3) from fresh moments on both sides: two
    steps. Loss and parameters within 1e-5."""
    h = 2
    w = world
    tx = optax.adam(1e-3) if opt == "adam" else optax.sgd(1.0)
    fmodel, jstate = _flax_state(tx)
    seeds_all = _seeds(h, 7)
    labels_all = w["labels"][seeds_all]
    mesh = Mesh(np.array(jax.devices()[:h]), ("host",))
    sharding = NamedSharding(mesh, P("host"))
    jstep = jbuild_e2e(fmodel, tx, SIZES, B, mesh, axis="host",
                       donate=False, fused_hot_hop=True,
                       fused_row_cap=ROW_CAP, fused_rng="hash",
                       fused_interpret=True)
    keys = [jax.random.key(11), jax.random.key(12)][:2 if opt == "adam"
                                                    else 1]
    before = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       jstate.params))
    before = {k: v.numpy() for k, v in before.items()}
    jnew, jlosses = jstate, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # JAX pads D=12 to 128 lanes
        for key in keys:
            jnew, jloss = jstep(
                jnew, jnp.asarray(w["feat"]), None, jnp.asarray(w["indptr"]),
                jnp.asarray(w["indices"]),
                jax.device_put(jnp.asarray(seeds_all), sharding),
                jax.device_put(jnp.asarray(labels_all), sharding), key)
            jlosses.append(float(jloss))
    hop_seeds = [[[int(_hop_seed(jax.random.fold_in(key, r), i))
                   for i in range(len(SIZES))] for r in range(h)]
                 for key in keys]
    after = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      jnew.params))
    res = pool.run(_rank_e2e_fused, h, w, before, seeds_all, labels_all,
                   hop_seeds, opt == "adam")[:h]
    for losses, params in res:
        np.testing.assert_allclose(losses, jlosses, **TOL)
        for name, want in after.items():
            # SGD at lr 1: before - after is the mean gradient
            np.testing.assert_allclose(before[name] - params[name],
                                       before[name] - want.numpy(),
                                       err_msg=name, **TOL)


def test_rank_step_seeds():
    a = [rank_step_seeds(5, r, 3) for r in range(4)]
    assert a == [rank_step_seeds(5, r, 3) for r in range(4)]
    assert len({tuple(x[0]) for x in a}) == 4
    assert rank_step_seeds(6, 0, 3) != a[0]
    assert all(-2**31 <= s < 2**31 for hs, d in a for s in hs + [d])
