"""The port's native CPU sampling engine (``quiver_tpu_torch/native``)
against the JAX package's (``quiver_tpu/native``) and against its own
plain numpy version, bit for bit.

Both engines key splitmix64 by ``(seed, v)``, so the same integer seed
gives the same picks, slots, counts and reindex in both, whatever the
thread count. The JAX loader falls back to numpy (another stream) when
it cannot build its engine, so every comparison first asserts that JAX's
``get_lib()`` loaded the C++ engine. The graph has isolated rows, rows
with ``deg <= k``, hubs past ``row_cap`` and, for the weighted draw,
rows of zero mass and zero-weight edges; the seeds include -1 and
repeats. The build tests point the loader at a scratch source and build
directory: a source that does not compile raises, and concurrent builds
leave one library."""

import threading

import numpy as np
import pytest

from quiver_tpu import native as jnative
from quiver_tpu_torch import native

N = 400


@pytest.fixture(scope="module")
def graph():
    g = np.random.default_rng(7)
    deg = np.minimum(g.lognormal(2.0, 1.3, N).astype(np.int64), 3000)
    deg[:6] = 0                      # isolated rows
    deg[6:9] = [2500, 2100, 1200]    # hubs, two past row_cap
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = g.integers(0, N, int(indptr[-1])).astype(np.int32)
    w = g.random(indices.shape[0]).astype(np.float32)
    w[g.random(w.shape[0]) < 0.25] = 0.0        # zero-weight edges
    for v in (10, 11):                          # rows of zero mass
        w[indptr[v]:indptr[v + 1]] = 0.0
    seeds = np.concatenate([np.arange(12), g.integers(-1, N, 250)]) \
        .astype(np.int32)
    seeds[[20, 40]] = -1
    return indptr, indices, w, seeds


@pytest.fixture(scope="module", autouse=True)
def jax_engine_loaded():
    assert jnative.get_lib() is not None, \
        "the JAX package's C++ engine did not load (its numpy fallback " \
        "draws another stream)"


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("threads", [1, 5])
@pytest.mark.parametrize("with_slots", [False, True])
@pytest.mark.parametrize("k", [1, 4, 15, 64])
def test_uniform_equals_jax_engine(graph, k, with_slots, threads):
    indptr, indices, _, seeds = graph
    ours = native.cpu_sample_layer(indptr, indices, seeds, k, seed=123,
                                   num_threads=threads,
                                   with_slots=with_slots)
    theirs = jnative.cpu_sample_layer(indptr, indices, seeds, k, seed=123,
                                      num_threads=threads,
                                      with_slots=with_slots)
    _equal(ours, theirs)


@pytest.mark.parametrize("row_cap", [50, 2048])
@pytest.mark.parametrize("with_slots", [False, True])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_weighted_equals_jax_engine(graph, k, with_slots, row_cap):
    indptr, indices, w, seeds = graph
    kw = dict(seed=2**40 + 9, row_cap=row_cap, with_slots=with_slots)
    ours = native.cpu_sample_layer_weighted(indptr, indices, w, seeds, k,
                                            num_threads=3, **kw)
    theirs = jnative.cpu_sample_layer_weighted(indptr, indices, w, seeds,
                                               k, **kw)
    _equal(ours, theirs)
    counts = ours[1]
    assert (counts[[10, 11]] == 0).all() and (ours[0][[10, 11]] == -1).all()


@pytest.mark.parametrize("k", [1, 4, 15, 64])
def test_uniform_plain_equals_engine(graph, k):
    indptr, indices, _, seeds = graph
    for seed in (0, 2**63 + 5):
        ours = native.cpu_sample_layer(indptr, indices, seeds, k, seed=seed,
                                       with_slots=True)
        plain = native.sample_layer_plain(indptr, indices, seeds, k,
                                          seed=seed, with_slots=True)
        _equal(ours, plain)
    nbrs, counts, slots = ours
    valid = seeds >= 0
    deg = np.where(valid, indptr[seeds + 1] - indptr[seeds], 0)
    assert np.array_equal(counts, np.minimum(deg, k))
    for i in np.flatnonzero(valid):          # distinct slots in the row
        s = slots[i, :counts[i]]
        assert np.unique(s).size == s.size
        assert ((s >= indptr[seeds[i]]) & (s < indptr[seeds[i] + 1])).all()


@pytest.mark.parametrize("row_cap", [50, 2048])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_weighted_plain_equals_engine(graph, k, row_cap):
    indptr, indices, w, seeds = graph
    kw = dict(seed=77, row_cap=row_cap, with_slots=True)
    _equal(native.cpu_sample_layer_weighted(indptr, indices, w, seeds, k,
                                            **kw),
           native.sample_layer_weighted_plain(indptr, indices, w, seeds, k,
                                              **kw))


def test_weighted_draws_follow_weights():
    """10,000 rows of neighbours 0..3 with weights 1:2:0:5, ``min(deg, k)
    = 4`` draws each (a row's draws are keyed by its id): the shares
    within 4 sigma of the weights'."""
    rows = 10000
    indptr = np.arange(0, 4 * rows + 1, 4, dtype=np.int64)
    indices = np.tile(np.arange(4, dtype=np.int32), rows)
    w = np.array([1, 2, 0, 5], np.float32)
    nbrs, counts = native.cpu_sample_layer_weighted(
        indptr, indices, np.tile(w, rows), np.arange(rows, dtype=np.int32),
        20, seed=5)
    assert (counts == 4).all() and (nbrs[:, 4:] == -1).all()
    p = np.bincount(nbrs[:, :4].reshape(-1), minlength=4) / (4 * rows)
    want = w / w.sum()
    assert np.all(np.abs(p - want) <= 4 * np.sqrt(want * (1 - want)
                                                  / (4 * rows)))


@pytest.mark.parametrize("k", [0, 3, 8])
def test_reindex_equals_jax_and_plain(graph, k):
    indptr, indices, _, seeds = graph
    nbrs = native.cpu_sample_layer(indptr, indices, seeds, k, seed=4)[0]
    ours = native.cpu_reindex(seeds, nbrs)
    theirs = jnative.cpu_reindex(seeds, nbrs)
    plain = native.reindex_plain(seeds, nbrs)
    for other in (theirs, plain):
        assert ours[1] == other[1]
        _equal([ours[0], ours[2], ours[3]], [other[0], other[2], other[3]])
    n_id, count = ours[0], ours[1]
    valid = seeds[seeds >= 0]
    assert np.array_equal(n_id[:np.unique(valid).size],
                          valid[np.sort(np.unique(valid,
                                                  return_index=True)[1])])
    assert (n_id[count:] == -1).all()


@pytest.mark.parametrize("with_slots", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_multihop_equals_jax_and_plain(graph, weighted, with_slots):
    indptr, indices, w, seeds = graph
    kw = dict(seed=11, weights=w if weighted else None, row_cap=300,
              with_slots=with_slots)
    ours = native.cpu_sample_multihop(indptr, indices, seeds[:60],
                                      [5, 3, 2], num_threads=4, **kw)
    theirs = jnative.cpu_sample_multihop(indptr, indices, seeds[:60],
                                         [5, 3, 2], **kw)
    plain = native.sample_multihop_plain(indptr, indices, seeds[:60],
                                         [5, 3, 2], **kw)
    for other in (theirs, plain):
        assert len(ours) == len(other)
        _equal([ours[0]], [other[0]])
        for a, b in zip(ours[1:], other[1:]):
            _equal(a, b)
    assert ours[0].shape == (60 * 6 * 4 * 3,)


def test_threads_do_not_change_the_draw(graph):
    indptr, indices, w, seeds = graph
    one = native.cpu_sample_layer(indptr, indices, seeds, 9, seed=3,
                                  num_threads=1, with_slots=True)
    many = native.cpu_sample_layer(indptr, indices, seeds, 9, seed=3,
                                   num_threads=7, with_slots=True)
    _equal(one, many)
    assert native.threads_used(1, 500) == 1
    assert native.threads_used(7, 3) == 3
    assert 1 <= native.threads_used(0, 10**6) == native.get_lib() \
        .qt_hardware_threads()


def test_inputs_are_validated(graph):
    indptr, indices, w, _ = graph
    with pytest.raises(ValueError, match="out of range"):
        native.cpu_sample_layer(indptr, indices, np.array([N], np.int32), 3)
    with pytest.raises(ValueError, match="must match"):
        native.cpu_sample_layer_weighted(indptr, indices, w[:-1],
                                         np.array([0], np.int32), 3)
    with pytest.raises(ValueError, match="fanout"):
        native.cpu_sample_layer(indptr, indices, np.array([0], np.int32), -1)
    with pytest.raises(ValueError, match="indptr ends"):
        native.cpu_sample_layer(indptr, indices[:10],
                                np.array([0], np.int32), 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "cpu_sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:          # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert paths[0].name == native.lib_path().name
    assert "libcpu_sampler_" in paths[0].name
