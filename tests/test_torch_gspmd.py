"""The port's 2-D (data x model) train step
(``quiver_tpu_torch/parallel/gspmd.py``: column-parallel Linears over a
2 x 2 ``DeviceMesh``) on 4 gloo ranks (one ``RankPool`` for the
module), the counterpart of ``tests/test_gspmd.py``:

- the Linears' weights and biases are split over ``model``: each rank
  holds half of every output dimension, the layout JAX's ``_leaf_spec``
  gives its flax kernels (``P(None, model)``) and biases (``P(model)``);
- each ``data`` rank walks only its slice of the seeds, with draws keyed
  by node id and hop: two steps (Adam, dropout 0.5) equal the same step
  at world size 1 (``mesh=None``: the whole batch in one keyed walk) on
  the same global batch, hop seeds and dropout seed: loss and parameters
  within 1e-5 (the sums run in another order), for the exact and the
  rotation sampler; rotation without ``indices_rows`` raises as JAX's
  step does;
- at 2 x 2 each ``data`` rank's sampled tree of each of its seeds is the
  world-1 walk's, and its frontier is its slice's, not the batch's;
- the keyed sampler keeps JAX's sampler's contract (membership,
  ``min(deg, k)`` picks, distinct picks) beside JAX's own draw;
- that world-1 step equals a plain loop written in the test (keyed
  walk, model, cross-entropy, Adam; no dropout) bit for bit;
- a width the model axis does not divide (5 classes over 2) is split
  3 + 2, where JAX's ``device_put`` refuses it;
- the loss falls over 12 steps.

Both sides start from the same flax-layout parameters
(``random_flax_params``, converted). Every pool call has the pool's
time limit and every collective the group's 60 s timeout."""

import numpy as np
import pytest
import torch

from chip_smoke import RankPool
from quiver_tpu_torch import GraphSAGE
from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                             random_flax_params)
from quiver_tpu_torch.ops import as_index_rows, edge_row_ids, permute_csr
from quiver_tpu_torch.parallel import (build_gspmd_train_step,
                                       full_parameters, init_state,
                                       shard_state, state_sharding)

N, DIM, HIDDEN = 300, 16, 16
SIZES = [4, 3]
B = 32
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout=60, call_timeout=120) as p:
        yield p


@pytest.fixture(scope="module")
def world():
    """``tests/test_gspmd.py``'s graph: n 300, D 16, degrees 1-9; labels
    a fixed projection's argmax (learnable)."""
    rng = np.random.default_rng(0)
    deg = rng.integers(1, 10, N)
    indptr = np.zeros(N + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    proj = rng.standard_normal((DIM, 5))
    return dict(indptr=indptr, indices=indices, feat=feat, proj=proj)


def _labels(w, classes):
    return np.argmax(w["feat"] @ w["proj"][:, :classes], axis=1) \
        .astype(np.int64)


def _model(classes, dropout=0.5):
    m = GraphSAGE(DIM, HIDDEN, classes, len(SIZES), dropout=dropout)
    m.load_state_dict(flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, classes, len(SIZES), seed=4)))
    return m


def _batches(steps, seed=3):
    g = np.random.default_rng(seed)
    return [(g.permutation(N)[:B].astype(np.int32),
             [int(v) for v in g.integers(-2**31, 2**31 - 1, len(SIZES))],
             int(g.integers(0, 2**31 - 1))) for _ in range(steps)]


def _rows(w, method):
    if method != "rotation":
        return None
    indptr = torch.from_numpy(w["indptr"])
    indices = torch.from_numpy(w["indices"])
    return as_index_rows(permute_csr(
        indices, edge_row_ids(indptr, indices.shape[0]),
        torch.Generator().manual_seed(2)))


def _args(w, classes, seeds):
    labels = torch.from_numpy(_labels(w, classes))
    s = torch.from_numpy(seeds)
    return (torch.from_numpy(w["feat"]), None, torch.from_numpy(w["indptr"]),
            torch.from_numpy(w["indices"]), s, labels[s.long()])


def _tp_rank(ctx, w, classes, method, batches):
    """On each rank: the TP state on a 2 x 2 mesh, the steps, and what
    the test holds: losses, each weight's local and full shape, and the
    full parameters after the steps."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = _model(classes)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    st = shard_state(init_state(model, opt), mesh)
    placements = {k: [str(p) for p in v]
                  for k, v in state_sharding(st, mesh).items()}
    step = build_gspmd_train_step(model, opt, SIZES, mesh, method=method)
    rows = _rows(w, method)
    losses = []
    for seeds, hs, drop in batches:
        st, loss = step(st, *_args(w, classes, seeds), hs, drop,
                        indices_rows=rows)
        losses.append(float(loss))
    out = {"losses": losses, "placements": placements,
           "local": {n: tuple(p.shape) for n, p in model.named_parameters()},
           "full": {n: t.numpy()
                    for n, t in full_parameters(model).items()}}
    if method == "rotation":
        try:
            step(st, *_args(w, classes, batches[0][0]), batches[0][1],
                 batches[0][2])
        except TypeError as e:
            out["no_rows"] = str(e)
    return out


def _single(w, classes, method, batches):
    """The oracle: the same step at world size 1, the keyed walk over the
    whole batch."""
    model = _model(classes)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = build_gspmd_train_step(model, opt, SIZES, None, method=method)
    state, losses = init_state(model, opt), []
    rows = _rows(w, method)
    for seeds, hs, drop in batches:
        state, loss = step(state, *_args(w, classes, seeds), hs, drop,
                           indices_rows=rows)
        losses.append(float(loss))
    return losses, {n: p.detach().numpy()
                    for n, p in model.named_parameters()}


@pytest.mark.parametrize("method", ["exact", "rotation"])
def test_tp_step_matches_the_single_rank_step(pool, world, method):
    batches = _batches(2)
    got = pool.run(_tp_rank, world, 4, method, batches)
    want_loss, want_params = _single(world, 4, method, batches)
    for r in got:
        np.testing.assert_allclose(r["losses"], want_loss, **TOL)
        for name, p in want_params.items():
            np.testing.assert_allclose(r["full"][name], p, **TOL)
    r0 = got[0]
    # every Linear's weight and bias split over model: half each rank
    for name, p in want_params.items():
        assert r0["placements"][name] == ["S(0)"]
        assert r0["local"][name][0] * 2 == p.shape[0]
        assert r0["local"][name][1:] == p.shape[1:]
    if method == "rotation":
        assert "requires indices_rows" in r0["no_rows"]


@pytest.mark.parametrize("method", ["exact", "rotation"])
def test_world_one_step_is_a_plain_loop(world, method):
    """The oracle above held to a loop written here, with no dropout:
    each step the keyed walk of the whole batch, the adjacencies, the
    model, torch's cross-entropy and Adam, in that order; the step's
    losses and parameters after two steps equal the loop's bit for
    bit."""
    import torch.nn.functional as F
    from quiver_tpu_torch.parallel import keyed_walk, layers_to_adjs
    batches = _batches(2, seed=6)
    rows = _rows(world, method)
    model = _model(4, dropout=0.0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = build_gspmd_train_step(model, opt, SIZES, None, method=method)
    state, got = init_state(model, opt), []
    for seeds, hs, drop in batches:
        state, loss = step(state, *_args(world, 4, seeds), hs, drop,
                           indices_rows=rows)
        got.append(float(loss))
    plain = _model(4, dropout=0.0)
    popt = torch.optim.Adam(plain.parameters(), lr=1e-2)
    want = []
    for seeds, hs, _ in batches:
        feat, _, indptr, indices, s, labels = _args(world, 4, seeds)
        with torch.no_grad():
            x, layers = keyed_walk(feat, None, indptr, indices, s, SIZES,
                                   hs, method=method, indices_rows=rows)
        plain.train()
        logits = plain(x, layers_to_adjs(layers, B, SIZES))[:B]
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        popt.step()
        popt.zero_grad(set_to_none=True)
        want.append(float(loss.detach()))
    assert got == want
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), name


def test_layout_is_jaxs_leaf_spec():
    """JAX's ``_leaf_spec`` on the flax tree against the port's placement
    of the converted parameters: a kernel ``P(None, model)`` (its output
    columns) is a torch weight split on dim 0, a bias ``P(model)`` is
    split on dim 0."""
    from jax.sharding import PartitionSpec as P
    from quiver_tpu.parallel.gspmd import _leaf_spec
    from quiver_tpu_torch.parallel.gspmd import _leaf_placement, _linears
    flax = random_flax_params(DIM, HIDDEN, 4, len(SIZES), seed=4)["params"]
    model = _model(4)
    linears = set(_linears(model))
    for conv, mods in flax.items():
        for lin, leaves in mods.items():
            for leaf, arr in leaves.items():
                spec = _leaf_spec(arr, "model")
                assert spec == (P(None, "model") if arr.ndim == 2
                                else P("model"))
                name = (f"convs.{conv[4:]}.{lin}."
                        + ("weight" if leaf == "kernel" else "bias"))
                t = dict(model.named_parameters())[name]
                assert [str(p) for p in _leaf_placement(
                    name, linears, t.dim())] == ["S(0)"]


def test_uneven_width_is_split_where_jax_refuses(pool, world):
    """5 classes over a model axis of 2: the port splits 3 + 2 and still
    equals the single-rank step; JAX's ``shard_state`` raises."""
    import jax
    import numpy as onp
    from jax.sharding import Mesh
    from quiver_tpu.parallel.gspmd import shard_state as jshard
    batches = _batches(2, seed=8)
    got = pool.run(_tp_rank, world, 5, "exact", batches)
    want_loss, want_params = _single(world, 5, "exact", batches)
    name = "convs.1.lin_root.weight"
    assert want_params[name].shape[0] == 5
    assert sorted(r["local"][name][0] for r in got) == [2, 2, 3, 3]
    for r in got:
        np.testing.assert_allclose(r["losses"], want_loss, **TOL)
        np.testing.assert_allclose(r["full"][name], want_params[name],
                                   **TOL)
    mesh = Mesh(onp.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    flax = jax.tree_util.tree_map(
        jax.numpy.asarray, random_flax_params(DIM, HIDDEN, 5, len(SIZES)))
    with pytest.raises(ValueError, match="divisible"):
        jshard(flax, mesh)


def test_tp_loss_falls(pool, world):
    batches = _batches(12, seed=5)
    got = pool.run(_tp_rank, world, 4, "exact", batches)
    losses = got[0]["losses"]
    assert all(r["losses"] == losses for r in got)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


class _Walks:
    """Records each walk a step takes: wraps ``gspmd.keyed_walk`` (the
    step's one sampler call) while the block runs, keeping its ``seeds``
    and ``layers``."""

    def __enter__(self):
        from quiver_tpu_torch.parallel import gspmd
        self.walks, self._mod = [], gspmd
        self._inner = inner = gspmd.keyed_walk

        def recording(feat, forder, indptr, indices, seeds, *a, **k):
            x, layers = inner(feat, forder, indptr, indices, seeds, *a, **k)
            self.walks.append({"seeds": seeds, "layers": layers})
            return x, layers
        gspmd.keyed_walk = recording
        return self

    def __exit__(self, *exc):
        self._mod.keyed_walk = self._inner


def _trees(walk):
    """Each seed's sampled tree from a walk's ``seeds`` and ``layers``:
    per hop, the set of sampled ``(parent, child)`` node pairs reachable
    from it."""
    seeds = walk["seeds"].tolist()
    layers = walk["layers"]
    fronts = [walk["seeds"]] + [layer.n_id for layer in layers]
    edges = []
    for i, layer in enumerate(layers):
        ok = layer.col >= 0
        par = fronts[i][layer.row[ok].long()].tolist()
        chi = layer.n_id[layer.col[ok].long()].tolist()
        hop = {}
        for u, v in zip(par, chi):
            hop.setdefault(u, set()).add(v)
        edges.append(hop)
    out = {}
    for s in seeds:
        if s < 0:
            continue
        reach, tree = {s}, []
        for hop in edges:
            pairs = {(u, v) for u in reach for v in hop.get(u, ())}
            tree.append(sorted(pairs))
            reach = reach | {v for _, v in pairs}
        out[s] = tree
    return out


def _walk_rank(ctx, w, batches):
    """On each rank: one TP step, then this rank's seeds, trees and
    frontier."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = _model(4)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    st = shard_state(init_state(model, opt), mesh)
    step = build_gspmd_train_step(model, opt, SIZES, mesh)
    seeds, hs, drop = batches[0]
    with _Walks() as rec:
        step(st, *_args(w, 4, seeds), hs, drop)
    (walk,) = rec.walks
    return {"data_rank": mesh["data"].get_local_rank(),
            "seeds": walk["seeds"].tolist(), "trees": _trees(walk),
            "frontier": sorted(v for v in
                               walk["layers"][-1].n_id.tolist() if v >= 0),
            "frontier_rows": int(walk["layers"][-1].n_count),
            "edges": int(sum(layer.edge_count
                             for layer in walk["layers"]))}


def test_data_ranks_walk_their_slice(pool, world):
    """Each ``data`` rank walks ``seeds[d*16:(d+1)*16]``: its tree of each
    of its seeds equals the world-1 walk's, its frontier is exactly the
    union of its seeds' trees (smaller than the whole batch's), and its
    sampled edges are ``min(deg, k)`` for each node of each of its hop
    frontiers."""
    batches = _batches(1, seed=11)
    got = pool.run(_walk_rank, world, batches)
    model = _model(4)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = build_gspmd_train_step(model, opt, SIZES, None)
    seeds, hs, drop = batches[0]
    with _Walks() as rec:
        step(init_state(model, opt), *_args(world, 4, seeds), hs, drop)
    (whole,) = rec.walks
    want = _trees(whole)
    part = B // 2
    for r in got:
        d = r["data_rank"]
        assert r["seeds"] == seeds[d * part:(d + 1) * part].tolist()
        assert set(r["trees"]) == set(r["seeds"])
        for s, tree in r["trees"].items():
            assert tree == want[s], s
        reach = sorted({v for s, tree in r["trees"].items()
                        for hop in tree for _, v in hop} | set(r["seeds"]))
        assert r["frontier"] == reach
        assert r["frontier_rows"] == len(reach)
        assert r["frontier_rows"] < int(whole["layers"][-1].n_count)
        # every node of hop i's frontier draws min(deg, k_i) edges
        deg = np.diff(world["indptr"])
        front, edges = set(r["seeds"]), 0
        for i, k in enumerate(SIZES):
            edges += int(np.minimum(deg[sorted(front)], k).sum())
            front |= {v for tree in r["trees"].values() for _, v in tree[i]}
        assert r["edges"] == edges
    assert {r["data_rank"] for r in got} == {0, 1}


@pytest.mark.parametrize("k", [1, 3, 9])
def test_keyed_sampler_keeps_jaxs_contract(world, k):
    """The keyed draw (``KeyedDraws``) beside JAX's ``sample_layer`` on
    the same seeds (-1 holes included): the same counts, ``min(deg, k)``;
    every pick a member of its row; no pick repeated within a row."""
    import jax
    import jax.numpy as jnp
    from quiver_tpu.ops import sample as jsample
    from quiver_tpu_torch.ops.sample import KeyedDraws, sample_layer
    indptr, indices = world["indptr"], world["indices"]
    rng = np.random.default_rng(k)
    seeds = rng.permutation(N)[:64].astype(np.int32)
    seeds[::7] = -1
    s = torch.from_numpy(seeds)
    nbrs, counts = sample_layer(torch.from_numpy(indptr),
                                torch.from_numpy(indices), s, k,
                                KeyedDraws(1234, s))
    jn, jc = jsample.sample_layer(jnp.asarray(indptr), jnp.asarray(indices),
                                  jnp.asarray(seeds), k,
                                  jax.random.PRNGKey(0))
    deg = np.where(seeds >= 0, indptr[seeds + 1] - indptr[seeds], 0)
    np.testing.assert_array_equal(counts.numpy(), np.minimum(deg, k))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    for picks, c in ((nbrs.numpy(), counts.numpy()),
                     (np.asarray(jn), np.asarray(jc))):
        for b, v in enumerate(seeds):
            row = picks[b, :c[b]]
            assert (picks[b, c[b]:] == -1).all()
            if v < 0:
                continue
            # distinct CSR slots: a row may list a neighbour twice, so
            # count each pick against the row's multiset
            nb = indices[indptr[v]:indptr[v + 1]].tolist()
            for p in row.tolist():
                assert p in nb
                nb.remove(p)


def test_keyed_sampler_is_uniform():
    """Chi-square of the keyed draw's picks over one row of degree 12
    (k 3), keyed by 4,000 hop seeds: every slot equally likely."""
    from quiver_tpu_torch.ops.sample import KeyedDraws, sample_layer
    indptr = torch.tensor([0, 12], dtype=torch.int32)
    indices = torch.arange(12, dtype=torch.int32)
    seeds = torch.zeros(1, dtype=torch.int32)
    hist = np.zeros(12)
    for seed in range(4000):
        nbrs, _ = sample_layer(indptr, indices, seeds, 3,
                               KeyedDraws(seed, seeds))
        np.add.at(hist, nbrs[0].numpy(), 1)
    expect = hist.sum() / 12
    chi2 = float(((hist - expect) ** 2 / expect).sum())
    assert chi2 < 31.3          # 11 degrees of freedom, p = 0.001
