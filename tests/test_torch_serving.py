"""The port's serve path against the JAX package's
``build_serve_step(fused_hot_hop=True)`` (``quiver_tpu/serving.py``),
with the per-hop kernel seeds JAX derives from its key, plus the guards
that keep the port apart from JAX and off the CPU unless asked.

Tiered serving (the port of ``tests/test_fused.py``'s cold-fixup tests):
the port's ``ServeEngine`` over the port's int8 ``Feature`` against
JAX's engine over JAX's store, logits within 1e-5 (the model's sums run
in another order, and XLA decodes the cold rows with a fused
multiply-add where the port rounds twice)."""

import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops import quant as jquant
from quiver_tpu.ops.pallas.fused import _hop_seed
from quiver_tpu.ops.sample import compact_layer as jcompact
from quiver_tpu.parallel.train import layers_to_adjs as jadjs
from quiver_tpu.pyg.sage_sampler import Adj as JAdj
from quiver_tpu.serving import ServeEngine as JServeEngine
from quiver_tpu.serving import build_serve_step as jbuild_serve_step
from quiver_tpu.utils import CSRTopo as JCSRTopo
from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, ServeEngine,
                              quantize)
from quiver_tpu_torch.models import flax_to_state_dict
from quiver_tpu_torch.parallel import (dedup_feature_gather, layers_to_adjs,
                                       masked_feature_gather)
from quiver_tpu_torch.serving import build_serve_step, sample_multihop_serving

REPO = Path(__file__).resolve().parents[1]
ROW_CAP = 16
N, DIM, HIDDEN, OUT = 300, 12, 16, 5
SIZES = [4, 3, 2]
CAP = 8


def _flax(sizes):
    """A flax GraphSAGE with ``len(sizes)`` layers and its variables."""
    fmodel = FlaxSAGE(hidden_dim=HIDDEN, out_dim=OUT,
                      num_layers=len(sizes), dropout=0.0)
    layers, cur = [], jnp.full((CAP,), -1, jnp.int32)
    for k in sizes:
        layers.append(jcompact(cur, jnp.full((cur.shape[0], k), -1,
                                             jnp.int32), seeds_dense=True))
        cur = layers[-1].n_id
    variables = fmodel.init(jax.random.key(0),
                            jnp.zeros((cur.shape[0], DIM)),
                            jadjs(layers, CAP, sizes))
    return fmodel, variables


@pytest.fixture(scope="module")
def setup():
    g = np.random.default_rng(3)
    deg = g.integers(0, 30, N)
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, N, indptr[-1]).astype(np.int32)
    feat = g.standard_normal((N, DIM)).astype(np.float32)
    perm = g.permutation(N).astype(np.int32)
    forder = np.empty(N, np.int32)
    forder[perm] = np.arange(N, dtype=np.int32)
    fmodel, variables = _flax(SIZES)
    return dict(indptr=indptr, indices=indices, feat=feat, forder=forder,
                fmodel=fmodel, variables=variables)


def _torch_model(setup):
    return GraphSAGE(DIM, HIDDEN, OUT, len(SIZES), dropout=0.0)


def _state(setup):
    return flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, setup["variables"]))


@pytest.mark.parametrize("kind", ["int8", "f32_forder"])
def test_engine_matches_jax_serve_step(setup, kind):
    s = setup
    if kind == "int8":
        jfeat = jquant.quantize(jnp.asarray(s["feat"]), "int8")
        feat, forder, jforder = quantize(s["feat"], "int8"), None, None
    else:
        jfeat, feat = jnp.asarray(s["feat"]), s["feat"]
        forder, jforder = s["forder"], jnp.asarray(s["forder"])
    seeds = np.full((CAP,), -1, np.int32)
    seeds[:6] = [3, 7, 11, 250, 0, 42]
    step = jbuild_serve_step(s["fmodel"], SIZES, CAP, fused_hot_hop=True,
                             fused_row_cap=ROW_CAP)
    key = jax.random.key(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # JAX pads D=12 to 128 lanes
        _, want = step(s["variables"], key, jfeat, jforder,
                       jnp.asarray(s["indptr"]), jnp.asarray(s["indices"]),
                       jnp.asarray(seeds))
    _, sub = jax.random.split(jax.random.key(5))
    hop_seeds = [int(_hop_seed(sub, i)) for i in range(len(SIZES))]

    topo = CSRTopo(indptr=s["indptr"], indices=s["indices"], device="cpu")
    eng = ServeEngine(_torch_model(s), _state(s), topo, feat, [SIZES], CAP,
                      forder=forder, fused_hot_hop=True,
                      fused_row_cap=ROW_CAP, device="cpu")
    got = eng.run(seeds[:6], hop_seeds=hop_seeds)
    assert got.shape == (CAP, OUT) and got.device.type == "cpu"
    np.testing.assert_allclose(got[:6].numpy(), np.asarray(want)[:6],
                               atol=1e-5, rtol=1e-5)


def test_engine_seeds_its_own_hops(setup):
    s = setup
    mk = lambda seed: ServeEngine(
        _torch_model(s), _state(s), (s["indptr"], s["indices"]), s["feat"],
        [SIZES, [2, 2, 1]], CAP, fused_hot_hop=True, fused_row_cap=ROW_CAP,
        seed=seed, device="cpu")
    a, b = mk(1).warmup(), mk(1).warmup()
    ids = np.array([5, 9, 13], np.int32)
    for variant in (0, 1):
        ra, rb = a.run(ids, variant), b.run(ids, variant)
        assert torch.equal(ra, rb) and torch.isfinite(ra).all()
    # an explicit replay of the drawn seeds reproduces the batch
    c = mk(4)
    hs = torch.randint(-2**31, 2**31 - 1, (3,),
                       generator=torch.Generator().manual_seed(4)).tolist()
    assert torch.equal(c.run(ids), mk(4).run(ids, hop_seeds=hs))
    with pytest.raises(ValueError, match="batch_cap"):
        a.run(np.arange(CAP + 1))


def test_deferred_pieces_raise(setup):
    s = setup
    args = (_torch_model(s), None, (s["indptr"], s["indices"]), s["feat"],
            [SIZES], CAP)
    # the windowed methods serve on the split route (no longer deferred)
    win = ServeEngine(*args, method="window", device="cpu")
    assert torch.isfinite(win.run(np.array([3, 7], np.int32))).all()
    with pytest.raises(ValueError, match="dedup_gather"):
        ServeEngine(*args, fused_hot_hop=True, dedup_gather=True,
                    device="cpu")
    # collect_metrics and refresh_feature are ported
    # (tests/test_torch_metrics.py, tests/test_torch_rotation.py)
    metered = ServeEngine(*args, fused_hot_hop=True, collect_metrics=True,
                          device="cpu")
    metered.run(np.array([3, 7], np.int32))
    assert metered.last_counters.shape == (25,)
    store = Feature(device_cache_size=100 * DIM * 4, device="cpu") \
        .from_cpu_tensor(s["feat"])
    eng = ServeEngine(*args[:3], store, [SIZES], CAP, fused_hot_hop=True,
                      device="cpu")
    assert eng.refresh_feature() is eng
    with pytest.raises(ValueError, match="Feature store"):
        ServeEngine(*args, device="cpu").refresh_feature()
    with pytest.raises(ValueError, match="fused_hot_rows"):
        build_serve_step(args[0], SIZES, CAP, fused_hot_hop=True,
                         gather=lambda feat, n_id, forder: feat)
    with pytest.raises(ValueError, match="exact"):
        build_serve_step(args[0], SIZES, CAP, method="rotation",
                         fused_hot_hop=True)
    with pytest.raises(ValueError, match="hop count"):
        ServeEngine(*args[:4], [SIZES, [2]], CAP, fused_hot_hop=True,
                    device="cpu")


def test_split_engine_serves_the_exact_sampler(setup):
    """``ServeEngine(fused_hot_hop=False)``: the exact sampler seeded with
    ``hop_seeds[0]`` (``sample_multihop_serving``), the masked gather
    and the model, composed by hand, give the engine's logits; the JAX
    model gives them too on the same sampled block."""
    s = setup
    eng = ServeEngine(_torch_model(s), _state(s),
                      (s["indptr"], s["indices"]), s["feat"], [SIZES], CAP,
                      forder=s["forder"], device="cpu")
    ids = np.array([3, 7, 11, 250, 0], np.int32)
    got = eng.run(ids, hop_seeds=[91, 5, 6])
    assert torch.equal(got, eng.run(ids, hop_seeds=[91, -1, 2]))
    assert not torch.equal(got, eng.run(ids, hop_seeds=[92, 5, 6]))
    assert torch.isfinite(eng.run(ids)).all()

    seeds = eng.pad_seeds(ids)
    n_id, layers = sample_multihop_serving(
        eng._indptr, eng._indices, seeds, SIZES,
        torch.Generator().manual_seed(91))
    x = masked_feature_gather(torch.from_numpy(s["feat"]), n_id,
                              torch.from_numpy(s["forder"]))
    with torch.inference_mode():
        want = eng.model(x, layers_to_adjs(layers, CAP, SIZES))[:CAP]
    assert torch.equal(got, want)
    jadj = [JAdj(jnp.asarray(a.edge_index.numpy()), None, a.size)
            for a in layers_to_adjs(layers, CAP, SIZES)]
    jlog = s["fmodel"].apply(s["variables"], jnp.asarray(x.numpy()), jadj)
    np.testing.assert_allclose(got[:5].numpy(), np.asarray(jlog)[:5],
                               atol=1e-5, rtol=1e-5)


def _tiered_stores(s, placement="offload"):
    """JAX's int8 store and the port's over the setup's table, each with a
    degree-ordered topo of the setup's graph; 120 of 300 rows hot."""
    jtopo = JCSRTopo(indptr=s["indptr"], indices=s["indices"])
    jstore = qv.Feature(rank=0, device_cache_size=120 * (DIM + 8),
                        cache_policy="device_replicate", csr_topo=jtopo,
                        dtype_policy="int8")
    jstore.from_cpu_tensor(s["feat"])
    topo = CSRTopo(indptr=s["indptr"], indices=s["indices"], device="cpu")
    store = Feature(device_cache_size=120 * (DIM + 8), csr_topo=topo,
                    dtype_policy="int8", host_placement=placement,
                    device="cpu").from_cpu_tensor(s["feat"])
    assert store.cache_rows == jstore.cache_rows == 120
    return jtopo, jstore, topo, store


@pytest.mark.parametrize("sizes", [[4], [3, 2]], ids=str)
@pytest.mark.parametrize("placement", ["offload", "numpy"])
def test_tiered_engine_matches_jax(setup, sizes, placement):
    """The cold fixup: hot frontier rows from the leaf kernel (bounded by
    the hot tier), cold ones overlaid from the store's lookup."""
    s = setup
    jtopo, jstore, topo, store = _tiered_stores(s, placement)
    fmodel, variables = _flax(sizes)
    jeng = JServeEngine(fmodel, variables, jtopo, jstore, [sizes], CAP,
                        fused_hot_hop=True, fused_row_cap=ROW_CAP)
    seeds = np.full((CAP,), -1, np.int32)
    seeds[:5] = [3, 7, 11, 250, 42]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # JAX pads D=12 to 128 lanes
        _, want = jeng._steps[0](variables, jax.random.key(5), jeng._feat,
                                 jeng._forder, jeng._indptr, jeng._indices,
                                 jnp.asarray(seeds))
    _, sub = jax.random.split(jax.random.key(5))
    hop_seeds = [int(_hop_seed(sub, i)) for i in range(len(sizes))]

    model = GraphSAGE(DIM, HIDDEN, OUT, len(sizes), dropout=0.0)
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    eng = ServeEngine(model, state, topo, store, [sizes], CAP,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP,
                      device="cpu")
    assert isinstance(eng._feat, tuple) and eng._feat[1] is not None
    got = eng.run(seeds[:5], hop_seeds=hop_seeds)
    np.testing.assert_allclose(got[:5].numpy(), np.asarray(want)[:5],
                               atol=1e-5, rtol=1e-5)

    # the frontier really holds cold slots, and the fixup fills them:
    # the walk over the store equals one lookup of the whole frontier
    from quiver_tpu_torch.ops.kernels import fused
    seeds_t = eng.pad_seeds(seeds[:5])
    n_id, layers, x = fused.fused_multihop(
        eng._indptr, eng._indices, seeds_t, store.device_part, sizes,
        hop_seeds, ROW_CAP, store.feature_order, store.cache_rows)
    cold = (n_id >= 0) & (store.feature_order[n_id.long().clamp(min=0)]
                          >= store.cache_rows)
    assert cold.any() and not x[cold].any()
    with torch.inference_mode():
        whole = eng.model(store.getitem_masked(n_id),
                          layers_to_adjs(layers, CAP, sizes))[:CAP]
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)


def test_tiered_split_route_serves_the_store(setup):
    """``fused_hot_hop=False`` over a store: the exact sampler, then the
    store's masked lookup as the gather."""
    s = setup
    _, _, topo, store = _tiered_stores(s)
    eng = ServeEngine(_torch_model(s), _state(s), topo, store, [SIZES], CAP,
                      device="cpu")
    ids = np.array([3, 7, 11, 250, 0], np.int32)
    got = eng.run(ids, hop_seeds=[91, 5, 6])
    n_id, layers = sample_multihop_serving(
        eng._indptr, eng._indices, eng.pad_seeds(ids), SIZES,
        torch.Generator().manual_seed(91))
    with torch.inference_mode():
        want = eng.model(store.getitem_masked(n_id),
                         layers_to_adjs(layers, CAP, SIZES))[:CAP]
    assert torch.equal(got, want) and torch.isfinite(got).all()


@pytest.mark.parametrize("budget", [True, 300, 2])
def test_split_route_dedup_gather(setup, budget):
    """``dedup_gather`` on the split route: the narrow unique gather (a
    budget the frontier's unique ids fit) or its overflow fallback (a
    budget of 2) gives the masked gather's rows, so the same logits."""
    s = setup
    mk = lambda **kw: ServeEngine(
        _torch_model(s), _state(s), (s["indptr"], s["indices"]), s["feat"],
        [SIZES], CAP, forder=s["forder"], device="cpu", **kw)
    eng, plain = mk(dedup_gather=budget), mk()
    ids = np.array([3, 7, 11, 250, 0], np.int32)
    got = eng.run(ids, hop_seeds=[91, 5, 6])
    assert torch.equal(got[:5], plain.run(ids, hop_seeds=[91, 5, 6])[:5])
    n_id, layers = sample_multihop_serving(
        eng._indptr, eng._indices, eng.pad_seeds(ids), SIZES,
        torch.Generator().manual_seed(91))
    x = dedup_feature_gather(eng._feat, n_id, eng._forder,
                             None if budget is True else budget)
    valid = n_id >= 0
    assert torch.equal(x[valid], masked_feature_gather(
        eng._feat, n_id, eng._forder)[valid])
    # the default budget (256 of 480 slots) and 300 take the narrow path,
    # 2 overflows
    n_uniq = int(torch.unique(n_id[valid]).numel())
    assert 2 < n_uniq <= 256 < n_id.shape[0]


def test_no_card_means_raise_not_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is used")
    s = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(_torch_model(s), None, (s["indptr"], s["indices"]),
                    s["feat"], [SIZES], CAP, fused_hot_hop=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CSRTopo(indptr=s["indptr"], indices=s["indices"])


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, quiver_tpu_torch, quiver_tpu_torch.parallel.train"
            ", quiver_tpu_torch.ops.sample_multihop, "
            "quiver_tpu_torch.models.sage, "
            "quiver_tpu_torch.pyg.sage_sampler, quiver_tpu_torch.ops.sample, "
            "quiver_tpu_torch.rpc, quiver_tpu_torch.serving\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'quiver_tpu' or "
            "m.startswith('quiver_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_never_name_jax():
    files = [p for p in (REPO / "quiver_tpu_torch").rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")]
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"\bjax\b|quiver_tpu\.")
    hits = [f"{p.relative_to(REPO)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if bad.search(line)]
    assert not hits, hits


@pytest.mark.parametrize("method", ["rotation", "window"])
def test_split_engine_serves_windowed_methods(setup, method):
    """``ServeEngine(method=...)`` on the split route: no rows view, so
    each batch permutes the topology once (``sample_multihop``'s
    fallback, as JAX's serve step does); the engine's logits are the
    composition of that sampler, seeded with ``hop_seeds[0]``, the
    masked gather and the model, and the sample holds the pick contract
    (graph edges, ``min(deg, k)`` per valid target)."""
    s = setup
    eng = ServeEngine(_torch_model(s), _state(s),
                      (s["indptr"], s["indices"]), s["feat"], [SIZES], CAP,
                      method=method, device="cpu")
    ids = np.array([3, 7, 11, 250, 0], np.int32)
    got = eng.run(ids, hop_seeds=[91, 5, 6])
    assert torch.isfinite(got).all() and got.shape == (CAP, OUT)
    seeds = eng.pad_seeds(ids)
    n_id, layers = sample_multihop_serving(
        eng._indptr, eng._indices, seeds, SIZES,
        torch.Generator().manual_seed(91), method=method)
    x = masked_feature_gather(torch.from_numpy(s["feat"]), n_id)
    with torch.inference_mode():
        want = eng.model(x, layers_to_adjs(layers, CAP, SIZES))[:CAP]
    assert torch.equal(got, want)
    indptr, indices = s["indptr"], s["indices"]
    cur = seeds.numpy()
    for lay, k in zip(layers, SIZES):
        lnid, row, col = lay.n_id.numpy(), lay.row.numpy(), lay.col.numpy()
        m = col >= 0
        for r, c in zip(row[m], col[m]):
            t, u = lnid[r], lnid[c]
            assert u in indices[indptr[t]:indptr[t + 1]]
        live = cur[cur >= 0]
        per = np.bincount(row[m], minlength=len(live))
        np.testing.assert_array_equal(per, np.minimum(np.diff(indptr)[live],
                                                      k))
        cur = lnid
