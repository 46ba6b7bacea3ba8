"""The port's disk tier (``Feature.set_mmap_file``/``read_mmap``, the
artifacts of ``quiver_tpu_torch/partition.py`` and the synthetic cold
dataset of ``datasets.py``) against the JAX package's, on the CPU:

- ``save_disk_tier`` writes the JAX package's files byte for byte (fp32,
  fp16 and int8; whole and in chunks);
- each package's store reads the other's artifact, and lookups (masked
  and unmasked, with and without ``feature_order``) equal JAX's bit for
  bit for fp32 and fp16 tiers. For int8 the port decodes as its kernels
  do, the multiply rounded and then the add (``quant.decode_np``), where
  JAX's host decode rounds once through float64: the port's rows equal
  the two-rounding decode of the artifact's codes bit for bit, and JAX's
  rows within one rounding;
- ``set_mmap_file`` refuses every bad input with JAX's message;
- ``load_disk_tier``'s refusals, ``load_disk_tier_store``, ``shape``;
- ``generate_synthetic_cold_dataset`` writes JAX's graph, labels and
  artifact byte for byte from the same seed (its decoded hot rows with the
  same rounding note), and ``load_synthetic_cold_dataset`` feeds a
  sampler through ``sample_ahead``;
- pickling, ``ServeEngine``'s and ``rotate_hot_set``'s refusals of a disk
  store with JAX's messages."""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu as jqv
from quiver_tpu import datasets as jdatasets
from quiver_tpu import partition as jpartition
from quiver_tpu import serving as jserving
from quiver_tpu.ops import quant as jquant
from quiver_tpu_torch import (CSRTopo, DeviceConfig, Feature, GraphSAGE,
                              GraphSageSampler, ServeEngine, datasets,
                              partition)
from quiver_tpu_torch.async_sampler import sample_ahead
from quiver_tpu_torch.ops import quant

N, DIM, CACHE = 500, 12, 150
POLICIES = [None, "fp16", "int8"]


def _feat(seed=0, n=N, dim=DIM):
    g = np.random.default_rng(seed)
    f = (g.standard_normal((n, dim))
         * g.choice([1e-3, 1.0, 1e3], (n, 1))).astype(np.float32)
    f[3] = 2.5                                   # a constant row
    return f


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("chunked", [False, True])
def test_artifact_byte_identical_to_jax(tmp_path, policy, chunked):
    feat = _feat(1)
    dm = np.random.default_rng(2).permutation(N)
    src = ((lambda lo, hi: feat[lo:hi]), N, DIM) if chunked else feat
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    meta = partition.save_disk_tier(src, dm, a, dtype_policy=policy,
                                    chunk_rows=37)
    jmeta = jpartition.save_disk_tier(src, dm, b, dtype_policy=policy,
                                      chunk_rows=37)
    assert meta == jmeta
    assert _files(a) == _files(b)
    with pytest.raises(FileExistsError):
        partition.save_disk_tier(feat, dm, a, dtype_policy=policy)
    partition.save_disk_tier(torch.from_numpy(feat), torch.from_numpy(dm),
                             a, dtype_policy=policy, overwrite=True)
    assert _files(a) == _files(b)


def test_artifact_refusals(tmp_path):
    feat = _feat()
    with pytest.raises(ValueError, match="bf16"):
        partition.save_disk_tier(feat, np.arange(N), str(tmp_path / "x"),
                                 dtype_policy="bf16")
    d = str(tmp_path / "bad")
    partition.save_disk_tier(feat[:50], np.arange(50), d)
    meta_path = os.path.join(d, "dtype_meta.json")
    meta = json.load(open(meta_path))
    for key, val, match in (("rows", 49, "refusing"),
                            ("kind", "something_else", "disk_tier")):
        bad = dict(meta, **{key: val})
        json.dump(bad, open(meta_path, "w"))
        for mod in (partition, jpartition):
            with pytest.raises(ValueError, match=match):
                mod.load_disk_tier(d)
    json.dump(meta, open(meta_path, "w"))
    kw, m = partition.load_disk_tier(d)
    jkw, jm = jpartition.load_disk_tier(d)
    assert m == jm and kw.keys() == jkw.keys()
    assert np.array_equal(kw["disk_map"], jkw["disk_map"])


def _hot(kwargs, policy):
    """The artifact's first CACHE rows decoded by the port: both
    packages' stores get these hot rows, so they differ in disk rows at
    most."""
    mm = np.load(kwargs["path"])
    if policy != "int8":
        return np.array(mm[:CACHE])
    return quant.decode_np(mm[:CACHE], np.load(kwargs["scale"])[:CACHE],
                           np.load(kwargs["zero"])[:CACHE])


def _one_rounding(kwargs):
    """Per file row and element, the most two decodes of one int8 code
    can differ by when one rounds the product and the other does not:
    one rounding of the product and one of the sum."""
    mm = np.load(kwargs["path"])
    prod = mm.astype(np.float32) * np.load(kwargs["scale"])
    return np.spacing(np.abs(prod)) + np.spacing(np.abs(_ref(kwargs,
                                                             "int8")))


def _ref(kwargs, policy, fma=False):
    """Every file row decoded: the port's two roundings, or with ``fma``
    the JAX package's float64 decode."""
    mm = np.load(kwargs["path"])
    if policy != "int8":
        return mm
    sc, ze = np.load(kwargs["scale"]), np.load(kwargs["zero"])
    if fma:
        return np.asarray(jquant.take_np(jquant.QuantizedTensor(mm, sc, ze),
                                         np.arange(mm.shape[0])))
    return quant.decode_np(mm, sc, ze)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("ordered", [False, True])
def test_cross_read_lookups(tmp_path, policy, writer, ordered):
    feat = _feat(3)
    g = np.random.default_rng(4)
    dm = g.permutation(N)
    d = str(tmp_path / "a")
    (partition if writer == "port" else jpartition).save_disk_tier(
        feat, dm, d, dtype_policy=policy)
    kw, _ = (jpartition if writer == "port" else partition).load_disk_tier(d)
    hot = _hot(kw, policy)
    t = Feature(device="cpu").from_mmap(None, DeviceConfig([hot], None))
    t.set_mmap_file(**kw)
    j = jqv.Feature().from_mmap(None, jqv.DeviceConfig([hot], None))
    j.set_mmap_file(**kw)
    order = None
    if ordered:
        local = g.permutation(N)
        t.set_local_order(local)
        j.set_local_order(local)
        order = np.empty(N, np.int64)
        order[local] = np.arange(N)
    assert t.shape == tuple(j.shape) == (N, DIM)
    storage = order if ordered else np.arange(N)
    ref = _ref(kw, policy)
    ref_rows = np.concatenate([hot, ref[dm[CACHE:]]])   # by storage row
    if policy == "int8":
        tol_rows = np.concatenate([np.zeros_like(hot),
                                   _one_rounding(kw)[dm[CACHE:]]])
    ids = g.integers(0, N, 200)
    masked = ids.copy()
    masked[g.random(200) < 0.2] = -1
    for got, want, m in ((t[ids], j[jnp.asarray(ids)], ids),
                         (t.getitem_masked(masked),
                          j.getitem_masked(jnp.asarray(masked)), masked)):
        got, want = got.numpy(), np.asarray(want)
        at = storage[np.clip(m, 0, N - 1)]
        exp = ref_rows[at] * (m >= 0)[:, None]
        np.testing.assert_array_equal(got, exp.astype(got.dtype))
        if policy != "int8":
            np.testing.assert_array_equal(got, want)
        else:
            # JAX decodes the same codes rounding once
            assert np.all(np.abs(got - want) <= tol_rows[at])
    rows, vec = t.lookup_tiered(masked, masked=True, collect_metrics=True)
    jrows, jvec = j.lookup_tiered(jnp.asarray(masked), masked=True,
                                  collect_metrics=True)
    assert np.asarray(vec).tolist() == np.asarray(jvec).tolist()
    np.testing.assert_array_equal(
        t.read_mmap(np.arange(0, N, 7)).numpy(), ref[np.arange(0, N, 7)])


def test_jax_decode_differs_by_one_rounding_at_most(tmp_path):
    """The int8 note made concrete: on this data the two decodes differ
    in some elements, never by more than one rounding."""
    d = str(tmp_path / "a")
    partition.save_disk_tier(_feat(5), np.arange(N), d)
    kw, _ = partition.load_disk_tier(d)
    two, one = _ref(kw, "int8"), _ref(kw, "int8", fma=True)
    assert np.all(np.abs(two - one) <= _one_rounding(kw))
    assert (two != one).any()
    store, _ = partition.load_disk_tier_store(d, device="cpu")
    assert store.cache_rows == 0
    np.testing.assert_array_equal(store[np.arange(N)].numpy(), two)


def test_load_disk_tier_store(tmp_path):
    d = str(tmp_path / "a")
    partition.save_disk_tier(_feat(6), np.arange(N), d)
    kw, _ = partition.load_disk_tier(d)
    manual = Feature(device="cpu").from_mmap(
        None, DeviceConfig([_hot(kw, "int8")], None))
    manual.set_mmap_file(**kw)
    shared, meta = partition.load_disk_tier_store(
        d, hot_rows=CACHE, prefetch_rows=64, device="cpu", workers=2)
    assert meta["rows"] == N and shared.cache_rows == CACHE
    assert shared._cold_prefetch.workers == 2
    ids = np.random.default_rng(7).integers(0, N, 64)
    assert torch.equal(manual[ids], shared[ids])
    jshared, _ = jpartition.load_disk_tier_store(d, hot_rows=CACHE)
    assert jshared.shape == shared.shape and jshared.cache_rows == CACHE
    shared.close()
    assert shared._cold_prefetch is None


def _validation_cases(kw, tmp_path):
    """``(name, build, args)``: ``build(pkg)`` a store of that package,
    ``args`` set_mmap_file's arguments that it must refuse."""
    wide = str(tmp_path / "wide.npy")
    np.save(wide, np.zeros((N, DIM + 1), np.float32))
    plain = str(tmp_path / "plain.npy")
    np.save(plain, np.zeros((40, DIM), np.float32))
    flat = str(tmp_path / "flat.npy")
    np.save(flat, np.zeros(40, np.float32))
    hot = _hot(kw, "int8")

    def hot_store(pkg):
        if pkg == "jax":
            return jqv.Feature().from_mmap(None, jqv.DeviceConfig([hot],
                                                                  None))
        return Feature(device="cpu").from_mmap(None,
                                               DeviceConfig([hot], None))

    def bare(pkg, **k):
        return jqv.Feature(**k) if pkg == "jax" \
            else Feature(device="cpu", **k)

    sides = (kw["scale"], kw["zero"])
    cases = [("short map", hot_store, (kw["path"], np.arange(CACHE - 1),
                                       *sides)),
             ("2-D map", bare, (kw["path"], np.zeros((N, 2), np.int64),
                                *sides)),
             ("float map", bare, (kw["path"], np.zeros(N, np.float32),
                                  *sides)),
             ("raw codes", bare, (kw["path"], np.arange(N))),
             ("one sidecar", bare, (kw["path"], np.arange(N), kw["scale"])),
             ("sidecar rows", bare, (kw["path"], np.arange(N),
                                     np.ones((N - 1, 1), np.float32),
                                     np.ones((N - 1, 1), np.float32))),
             ("sidecars on fp32", bare, (plain, np.arange(40),
                                         np.ones(40, np.float32),
                                         np.ones(40, np.float32))),
             ("width", hot_store, (wide, np.arange(N))),
             ("policy", lambda pkg: bare(pkg, dtype_policy={
                 "hot": None, "cold": "int8"}), (plain, np.arange(40))),
             ("rank", bare, (flat, np.arange(40)))]
    for bad in (-3, N):
        dm = np.arange(N)
        dm[N - 1] = bad
        cases.append((f"entry {bad}", hot_store, (kw["path"], dm, *sides)))
    return cases


def test_set_mmap_file_refusals_match_jax(tmp_path):
    d = str(tmp_path / "a")
    partition.save_disk_tier(_feat(8), np.arange(N), d)
    kw, _ = partition.load_disk_tier(d)
    for name, build, args in _validation_cases(kw, tmp_path):
        with pytest.raises(ValueError) as got:
            build("port").set_mmap_file(*args)
        with pytest.raises(ValueError) as want:
            build("jax").set_mmap_file(*args)
        assert str(got.value) == str(want.value), name
    # entries below the hot tier are never read: any sentinel is allowed,
    # and the map may come as a tensor
    dm = np.arange(N)
    dm[:CACHE] = -1
    f = Feature(device="cpu").from_mmap(None, DeviceConfig(
        [_hot(kw, "int8")], None))
    f.set_mmap_file(kw["path"], torch.from_numpy(dm), kw["scale"],
                    kw["zero"])
    assert f.shape == (N, DIM)
    with pytest.raises(ValueError, match="set_mmap_file first"):
        Feature(device="cpu").read_mmap([0])


def test_synthetic_cold_dataset_equals_jax(tmp_path):
    kw = dict(nodes=1200, dim=8, avg_deg=5, hot_frac=0.2, seed=3)
    a, b, c = (str(tmp_path / x) for x in "abc")
    meta = datasets.generate_synthetic_cold_dataset(a, chunk_rows=256, **kw)
    jmeta = jdatasets.generate_synthetic_cold_dataset(b, chunk_rows=256,
                                                      **kw)
    datasets.generate_synthetic_cold_dataset(c, chunk_rows=100, **kw)
    assert meta == jmeta and meta["hot_rows"] == 240
    for rel in ("indptr.npy", "indices.npy", "labels.npy", "meta.json",
                "disk/disk_rows.npy", "disk/disk_scale.npy",
                "disk/disk_zero.npy", "disk/disk_map.npy",
                "disk/dtype_meta.json"):
        want = open(os.path.join(b, rel), "rb").read()
        assert open(os.path.join(a, rel), "rb").read() == want, rel
        assert open(os.path.join(c, rel), "rb").read() == want, rel
    with pytest.raises(FileExistsError):
        datasets.generate_synthetic_cold_dataset(a, **kw)
    with pytest.raises(ValueError, match="hot_frac"):
        datasets.generate_synthetic_cold_dataset(str(tmp_path / "d"),
                                                 hot_frac=0.0)
    # the hot rows: the artifact's first rows decoded by this package's
    # rounding, within one rounding of JAX's float64 decode
    dkw, _ = partition.load_disk_tier(os.path.join(a, "disk"))
    hot, jhot = (np.load(os.path.join(x, "hot_rows.npy")) for x in (a, b))
    np.testing.assert_array_equal(hot, _ref(dkw, "int8")[:240])
    np.testing.assert_array_equal(hot, np.load(os.path.join(c,
                                                            "hot_rows.npy")))
    assert np.all(np.abs(hot - jhot) <= _one_rounding(dkw)[:240])

    topo, store, meta2 = datasets.load_synthetic_cold_dataset(
        a, device="cpu")
    _, pstore, _ = datasets.load_synthetic_cold_dataset(
        a, prefetch_rows=512, device="cpu", workers=2)
    jtopo, _, _ = jdatasets.load_synthetic_cold_dataset(b)
    assert meta2 == meta and store.shape == (1200, 8)
    assert store.cache_rows == 240 and pstore._cold_prefetch.workers == 2
    assert np.array_equal(topo.indptr.numpy(), np.asarray(jtopo.indptr))
    assert np.array_equal(topo.indices.numpy(), np.asarray(jtopo.indices))
    assert (np.diff(topo.degree.numpy()) <= 0).all()
    ids = np.random.default_rng(1).integers(0, 1200, 64)
    np.testing.assert_array_equal(store[ids].numpy(),
                                  _ref(dkw, "int8")[ids])
    sampler = GraphSageSampler(topo, [4, 3], seed=2, device="cpu")
    seeds = [torch.from_numpy(np.random.default_rng(s).integers(
        0, 1200, 32).astype(np.int32)) for s in range(3)]
    for n_id, bs, _ in sample_ahead(sampler, seeds, pstore):
        assert bs == 32
        assert torch.equal(pstore.getitem_masked(n_id),
                           store.getitem_masked(n_id))
    st = pstore._cold_prefetch.stats()
    assert st["published"] == 3 and st["hit_rows"] > 0
    store.close()
    pstore.close()


def test_pickling_rotation_and_serving_refuse_as_jax(tmp_path):
    d = str(tmp_path / "a")
    partition.save_disk_tier(_feat(9), np.arange(N), d)
    t, _ = partition.load_disk_tier_store(d, hot_rows=CACHE,
                                          prefetch_rows=64, device="cpu")
    j, _ = jpartition.load_disk_tier_store(d, hot_rows=CACHE)
    local = np.random.default_rng(1).permutation(N)
    t.set_local_order(local)
    j.set_local_order(local)
    ids = np.random.default_rng(2).integers(0, N, 64)
    t.stage_frontier(ids).result(timeout=30)
    back = pickle.loads(pickle.dumps(t))
    assert back._cold_prefetch is None and t._cold_prefetch is not None
    assert torch.equal(back[ids], t[ids]) and back.shape == t.shape
    back.enable_cold_prefetch(64)       # file rows, not file-backed: mmap
    assert back._cold_prefetch.stats()["io"]["engine"] == "mmap"
    back.stage_frontier(ids).result(timeout=30)
    assert torch.equal(back[ids], t[ids])
    back.close()
    for store in (t, j):
        with pytest.raises(ValueError, match="numpy host tier") as e:
            store.rotate_hot_set([local[-1]], [local[0]])
        if store is t:
            msg = str(e.value)
    assert msg == str(e.value)
    with pytest.raises(ValueError) as je:
        jserving._feature_gather(j)
    model = GraphSAGE(DIM, 8, 3, 2, dropout=0.0)
    topo = CSRTopo(indptr=np.arange(N + 1), indices=np.arange(N),
                   device="cpu")
    with pytest.raises(ValueError) as te:
        ServeEngine(model, None, topo, t, [[2, 2]], 8, device="cpu")
    assert str(te.value) == str(je.value)
    t.close()
    j.close()
