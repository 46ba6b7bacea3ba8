"""The rest of the host side of the port, on the CPU, against the JAX
package where it has a counterpart:

- ``Feature.prefetch`` equal to ``feature[ids]`` bit for bit (tiered
  offload, numpy host path, all-hot; fp32 and int8), its id snapshot,
  ``close``, ``stage_frontier`` and pickling with a live pipeline;
- ``async_sampler``: ``sample_ahead`` yields the serial ``sample()``
  results in order from one generator state, and publishes each
  frontier; ``AsyncNeighborSampler``'s per-layer API;
- ``layerwise_inference`` within 1e-5 of JAX's on flax parameters carried
  over by ``models/convert.py``, with hubs spanning several windows, and
  ``neighborhood_block`` equal to JAX's;
- ``datasets.from_numpy_dir`` (``.npz`` and a directory, labels with
  negative sentinels) and ``generate_drifting_trace`` equal to JAX's;
- artifacts written by either package read by the other, and the
  checkpoint round trip of a ``TrainState``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu as jqv
from quiver_tpu import checkpoint as jcheckpoint
from quiver_tpu import datasets as jdatasets
from quiver_tpu import inference as jinference
from quiver_tpu.async_sampler import AsyncNeighborSampler as JAsyncSampler
from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE,
                              GraphSageSampler, checkpoint, datasets,
                              inference)
from quiver_tpu_torch.async_sampler import (AsyncCudaNeighborSampler,
                                            AsyncNeighborSampler,
                                            sample_ahead)
from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                             random_flax_params)
from quiver_tpu_torch.parallel import init_state

N, DIM = 300, 8


def _graph(n=N, seed=0, hubs=()):
    g = np.random.default_rng(seed)
    deg = g.integers(0, 12, n)
    deg[:3] = 0
    for v, d in hubs:
        deg[v] = d
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, g.integers(0, n, int(indptr[-1])).astype(np.int32)


def _table(n=N, dim=DIM, seed=1):
    return np.random.default_rng(seed).standard_normal((n, dim)) \
        .astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.is_floating_point() else t


# -- Feature.prefetch ---------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(host_placement="offload", dtype_policy="int8", dedup_cold=True),
    dict(host_placement="offload", cold_budget=16),
    dict(host_placement="numpy"),
    dict(host_placement="offload", dtype_policy="int8", cache="all")],
    ids=["offload-int8-dedup", "offload-fp32-budget", "numpy", "all-hot"])
def test_prefetch_equals_lookup(kw):
    kw = dict(kw)
    cache = N * DIM * 4 if kw.pop("cache", None) else 60 * DIM * 4
    indptr, indices = _graph()
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    f = Feature(device_cache_size=cache, csr_topo=topo, device="cpu", **kw) \
        .from_cpu_tensor(_table())
    g = np.random.default_rng(2)
    batches = [g.integers(0, N, 90).astype(np.int32) for _ in range(5)]
    futs = [f.prefetch(torch.from_numpy(b)) for b in batches]
    ids = torch.from_numpy(batches[0].copy())
    snap = f.prefetch(ids)
    ids.fill_(0)                               # the caller reuses its buffer
    for b, fut in zip(batches, futs):
        got = fut.result(timeout=30)
        assert torch.equal(_bits(got), _bits(f[b]))
    assert torch.equal(_bits(snap.result(timeout=30)), _bits(f[batches[0]]))
    assert f.stage_frontier(batches[0]) is None
    stats = f._pool.stats()
    assert stats["completed"] == 6 and stats["failed"] == 0
    f.close()
    f.close()
    assert f._pool is None
    assert torch.equal(f.prefetch(batches[1]).result(timeout=30), f[batches[1]])
    import pickle
    back = pickle.loads(pickle.dumps(f))        # a live pipeline pickles
    assert back._pool is None and torch.equal(back[batches[2]], f[batches[2]])
    f.close()


def test_prefetch_failure_surfaces():
    f = Feature(device_cache_size=0, device="cpu").from_cpu_tensor(_table())
    fut = f.prefetch(np.array([N + 5], np.int64))
    with pytest.raises(IndexError):
        fut.result(timeout=30)
    assert torch.equal(f.prefetch([1, 2]).result(timeout=30), f[[1, 2]])
    f.close()


# -- async_sampler ------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.frontiers = []

    def stage_frontier(self, n_id):
        self.frontiers.append(n_id.clone())
        return None


@pytest.mark.parametrize("mode", ["HBM", "CPU"])
def test_sample_ahead_equals_serial(mode):
    indptr, indices = _graph()
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    batches = [np.arange(i * 20, (i + 1) * 20, dtype=np.int32)
               for i in range(6)]
    serial_s = GraphSageSampler(topo, [3, 2], device="cpu", mode=mode,
                                seed=4)
    serial = [serial_s.sample(b) for b in batches]
    ahead_s = GraphSageSampler(topo, [3, 2], device="cpu", mode=mode,
                               seed=4)
    rec = _Recorder()
    ahead = list(sample_ahead(ahead_s, batches, feature=rec, depth=2))
    assert len(ahead) == len(serial)
    for x, y, fr in zip(serial, ahead, rec.frontiers):
        assert torch.equal(x[0], y[0]) and x[1] == y[1]
        assert torch.equal(fr, y[0])
        for a, b in zip(x[2], y[2]):
            assert torch.equal(a.edge_index, b.edge_index) and a.size == b.size
    f = Feature(device_cache_size=0, device="cpu").from_cpu_tensor(_table())
    assert len(list(sample_ahead(ahead_s, batches[:2], feature=f))) == 2


def test_async_neighbor_sampler():
    indptr, indices = _graph()
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    assert AsyncCudaNeighborSampler is AsyncNeighborSampler
    s = AsyncNeighborSampler(topo, device="cpu", seed=3)
    seeds = np.arange(10, 30, dtype=np.int32)
    nbrs, counts = s.sample_layer(seeds, 4)
    deg = indptr[seeds + 1] - indptr[seeds]
    assert np.array_equal(counts.numpy(), np.minimum(deg, 4))
    for i, v in enumerate(seeds):
        got = nbrs[i, :counts[i]].numpy()
        assert set(got) <= set(indices[indptr[v]:indptr[v + 1]])
    n_id, row, col = s.reindex(seeds, nbrs)
    jn_id, jrow, jcol = JAsyncSampler(
        jqv.CSRTopo(indptr=indptr, indices=indices)).reindex(
            seeds, nbrs.numpy())
    assert np.array_equal(n_id.numpy(), np.asarray(jn_id))
    assert np.array_equal(row.numpy(), np.asarray(jrow))
    assert np.array_equal(col.numpy(), np.asarray(jcol))


# -- inference ----------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 1, 3])
def test_neighborhood_block_equals_jax(window):
    indptr, indices = _graph(hubs=[(5, 40), (9, 17)])
    nodes = np.array([5, 9, 0, -1, 17, 299, 40], np.int32)
    ours = inference.neighborhood_block(torch.from_numpy(indptr),
                                        torch.from_numpy(indices),
                                        torch.from_numpy(nodes), 16, window)
    theirs = jinference.neighborhood_block(jnp.asarray(indptr),
                                           jnp.asarray(indices),
                                           jnp.asarray(nodes), 16, window)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("batch", [64, 300])
def test_layerwise_inference_equals_jax(batch):
    """Hubs of 70 and 130 neighbours span 5 and 9 windows of 16."""
    indptr, indices = _graph(hubs=[(5, 70), (200, 130), (7, 16)])
    x = _table(seed=5)
    flax = random_flax_params(DIM, 16, 5, 3, seed=9)
    model = GraphSAGE(DIM, 16, 5, 3)
    model.load_state_dict(flax_to_state_dict(flax))
    ours = inference.layerwise_inference(
        inference.sage_apply_layer(model), torch.from_numpy(indptr),
        torch.from_numpy(indices), torch.from_numpy(x), 3,
        batch_size=batch, max_degree=16)
    params = [{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
               for k, v in flax["params"][f"conv{i}"].items()}
              for i in range(3)]
    theirs = jinference.layerwise_inference(
        jinference.sage_apply_layer(params), indptr, indices,
        jnp.asarray(x), 3, batch_size=batch, max_degree=16)
    assert ours.shape == (N, 5) and not ours.requires_grad
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-5)


def test_layerwise_inference_exact_mean():
    """One layer whose apply returns the mean: every node's exact mean
    (zeros when isolated), whatever the window width."""
    indptr, indices = _graph(hubs=[(5, 70)])
    x = torch.from_numpy(_table(seed=6))
    ref = torch.zeros_like(x)
    for v in range(N):
        nb = indices[indptr[v]:indptr[v + 1]]
        if nb.size:
            ref[v] = x[torch.from_numpy(nb).long()].double().mean(0).float()
    for md in (4, 16, 256):
        got = inference.layerwise_inference(
            lambda i, xs, m: m, torch.from_numpy(indptr),
            torch.from_numpy(indices), x, 1, batch_size=50, max_degree=md)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="int64 indptr"):
        class Huge:
            shape = (2**31,)
        inference.layerwise_inference(lambda *a: a[1],
                                      torch.zeros(3, dtype=torch.int32),
                                      Huge(), x, 1)


# -- datasets -----------------------------------------------------------------


def _dump(tmp_path, as_dir):
    g = np.random.default_rng(3)
    n = 120
    data = dict(edge_index=g.integers(0, n, (2, 700)),
                feat=g.standard_normal((n, 6)).astype(np.float32),
                labels=g.integers(-1, 5, (n, 1)),
                train_idx=np.arange(0, 60), valid_idx=np.arange(60, 90))
    if as_dir:
        d = tmp_path / "dump"
        d.mkdir()
        for k, v in data.items():
            np.save(d / f"{k}.npy", v)
        return str(d)
    path = str(tmp_path / "dump.npz")
    np.savez(path, **data)
    return path


@pytest.mark.parametrize("as_dir", [False, True])
@pytest.mark.parametrize("undirected", [False, True])
def test_from_numpy_dir_equals_jax(tmp_path, as_dir, undirected):
    path = _dump(tmp_path, as_dir)
    ours = datasets.from_numpy_dir(path, undirected=undirected, device="cpu")
    theirs = jdatasets.from_numpy_dir(path, undirected=undirected)
    for name in ("indptr", "indices", "eid"):
        assert np.array_equal(getattr(ours.csr_topo, name).numpy(),
                              np.asarray(getattr(theirs.csr_topo, name)))
    for name in ("feat", "train_idx", "valid_idx"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours.test_idx is None and theirs.test_idx is None
    assert np.array_equal(ours.labels, theirs.labels, equal_nan=True)
    assert ours.labels.dtype == theirs.labels.dtype == np.float32
    assert ours.num_classes == theirs.num_classes


def test_from_numpy_dir_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        datasets.from_numpy_dir(str(tmp_path / "none"), device="cpu")
    np.savez(tmp_path / "x.npz", feat=np.zeros((3, 2)))
    with pytest.raises(KeyError, match="missing"):
        datasets.from_numpy_dir(str(tmp_path / "x.npz"), device="cpu")
    np.savez(tmp_path / "y.npz", edge_index=np.array([[0, 5], [1, 1]]),
             feat=np.zeros((3, 2)), labels=np.zeros(3), train_idx=[0])
    with pytest.raises(ValueError, match="references node"):
        datasets.from_numpy_dir(str(tmp_path / "y.npz"), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(length=50_000, nodes=10_000),
    dict(length=20_000, nodes=777, skew=1.5, rotate_every=3000, seed=4),
    dict(length=30_000, nodes=5000, stride=13, lo=8000, hi=25_001)])
def test_drifting_trace_equals_jax(kw):
    ours = datasets.generate_drifting_trace(**kw)
    theirs = jdatasets.generate_drifting_trace(**kw)
    assert ours.dtype == theirs.dtype == np.int64
    assert np.array_equal(ours, theirs)
    whole = datasets.generate_drifting_trace(**{**kw, "lo": 0, "hi": None})
    lo = kw.get("lo", 0)
    assert np.array_equal(whole[lo:lo + ours.shape[0]], ours)


# -- checkpoint ---------------------------------------------------------------


def test_artifacts_read_across_packages(tmp_path):
    order = np.random.default_rng(1).permutation(50).astype(np.int32)
    p1 = checkpoint.save_artifact(str(tmp_path / "a" / "ours.npz"),
                                  order=torch.from_numpy(order),
                                  book=np.arange(4))
    p2 = jcheckpoint.save_artifact(str(tmp_path / "theirs.npz"),
                                   order=jnp.asarray(order),
                                   book=np.arange(4))
    for got in (jcheckpoint.load_artifact(p1), checkpoint.load_artifact(p2),
                checkpoint.load_artifact(p1)):
        assert sorted(got) == ["book", "order"]
        assert np.array_equal(got["order"], order)
        assert got["order"].dtype == np.int32
        assert np.array_equal(got["book"], np.arange(4))


def _trained_state(seed=0):
    torch.manual_seed(seed)
    model = GraphSAGE(DIM, 16, 5, 2, dropout=0.0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x = torch.randn(40, DIM)
    for _ in range(3):
        opt.zero_grad()
        model.convs[0].lin_root(x).square().mean().backward()
        opt.step()
    return init_state(model, opt)._replace(step=3), x


def test_checkpoint_round_trip(tmp_path):
    state, x = _trained_state()
    path = checkpoint.save_state(str(tmp_path / "ck"), state, step=3)
    assert os.path.isabs(path)
    with pytest.raises(FileExistsError):
        checkpoint.save_state(str(tmp_path / "ck"), state, step=3,
                              force=False)
    fresh_model = GraphSAGE(DIM, 16, 5, 2, dropout=0.0)
    fresh = init_state(fresh_model, torch.optim.Adam(
        fresh_model.parameters(), lr=1e-2))
    got = checkpoint.restore_state(str(tmp_path / "ck"), fresh, step=3)
    assert got.step == 3 and got.model is fresh_model
    for a, b in zip(state.model.state_dict().values(),
                    got.model.state_dict().values()):
        assert torch.equal(a, b)
    # one more step from each gives the same bits
    for st in (state, got):
        st.optimizer.zero_grad()
        st.model.convs[0].lin_root(x).square().mean().backward()
        st.optimizer.step()
    for a, b in zip(state.model.parameters(), got.model.parameters()):
        assert torch.equal(a, b)
    checkpoint.save_state(str(tmp_path / "flat"), state)
    assert checkpoint.restore_state(str(tmp_path / "flat"), fresh).step == 3
