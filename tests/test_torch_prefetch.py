"""The port's cold-tier prefetch (``quiver_tpu_torch/prefetch.py``,
``Feature.enable_cold_prefetch``/``stage_frontier``) against the JAX
package's on the same int8 artifact and the same traces, on the CPU:

- lookups with the prefetcher on equal the store without it bit for bit
  (unmasked and masked, with and without ``feature_order``), for both
  ring layouts (``decode_staged``) and 1 and 2 staging workers, and equal
  the artifact's rows decoded on the host;
- counter slots 13-20 and 22 of the metered lookup equal JAX's on the
  same trace (partial staging, wrap-around, hot ids, IO facts at one
  reader thread), and so do ``stats()``, ``observe_into``, dropped
  publications, ring truncation and ``wait_inflight``;
- the ring stays consistent under concurrent stagers and under a stager
  that wraps around while lookups read it;
- the ``prefetch.stager`` and ``io.read`` fault sites behave as JAX's
  (shard retry, counted restarts, synchronous fallback);
- lifecycle: ``close`` drains, reaps its threads and detaches, the
  context manager, re-attaching the file;
- ``sample_ahead`` stages: its batches' lookups hit the ring;
- every CUDA event the store, the mixed sampler and the prefetcher
  record goes on a stream of the ids' device (``torch.cuda`` patched:
  this runs on the CPU)."""

import logging
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu as jqv
from quiver_tpu import faults as jfaults
from quiver_tpu_torch import (CSRTopo, DeviceConfig, Feature,
                              GraphSageSampler, MixedGraphSageSampler,
                              faults, metrics, prefetch)
from quiver_tpu_torch.async_sampler import sample_ahead
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.partition import load_disk_tier, save_disk_tier

N, DIM, CACHE = 600, 12, 200
SLOTS = list(range(metrics.PREFETCH_HIT_ROWS, metrics.IO_RETRIES + 1)) \
    + [metrics.STAGING_RESTARTS]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    d = str(tmp_path_factory.mktemp("cold") / "disk")
    save_disk_tier(feat, np.arange(N, dtype=np.int64), d,
                   dtype_policy="int8")
    kwargs, _ = load_disk_tier(d)
    codes = np.load(kwargs["path"])
    ref = quant.decode_np(codes, np.load(kwargs["scale"]),
                          np.load(kwargs["zero"]))
    return kwargs, ref


def port_store(artifact, order=None, **pf):
    kwargs, ref = artifact
    f = Feature(device="cpu").from_mmap(
        None, DeviceConfig([ref[:CACHE]], None))
    f.set_mmap_file(**kwargs)
    if order is not None:
        f.set_local_order(order)
    if pf:
        f.enable_cold_prefetch(**pf)
    return f


def jax_store(artifact, order=None, **pf):
    kwargs, ref = artifact
    f = jqv.Feature().from_mmap(None, jqv.DeviceConfig([ref[:CACHE]], None))
    f.set_mmap_file(**kwargs)
    if order is not None:
        f.set_local_order(order)
    if pf:
        f.enable_cold_prefetch(**pf)
    return f


def frontier_batches(rng, count, size=128, pad_frac=0.25):
    out = []
    for _ in range(count):
        pool = rng.integers(0, N, max(size // 4, 1))
        ids = pool[rng.integers(0, pool.size, size)].astype(np.int64)
        ids[rng.random(size) < pad_frac] = -1
        out.append(ids)
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


def _run(store, steps, jax_side):
    """Replay ``steps`` (``("publish", ids)``, ``("lookup", ids)``) on a
    store: publications block until staged; returns the metered
    lookups' counter vectors as numpy."""
    vecs = []
    for kind, ids in steps:
        if kind == "publish":
            store.stage_frontier(jnp.asarray(ids) if jax_side else ids
                                 ).result(timeout=30)
        else:
            _, vec = store.lookup_tiered(
                jnp.asarray(ids) if jax_side else ids, collect_metrics=True)
            vecs.append(np.asarray(vec))
    return vecs


# -- the ring -----------------------------------------------------------------

def test_ring_stays_consistent_under_concurrent_stagers():
    total, cap, dim = 500, 64, 4
    ring = prefetch.StagingRing(cap, dim, np.float32, total)
    src = np.random.default_rng(1).standard_normal((total, dim)) \
        .astype(np.float32)
    errs = []

    def stager(seed):
        r = np.random.default_rng(seed)
        for _ in range(30):
            ids = ring.missing(np.unique(r.integers(0, total, 40)))[:cap]
            if ids.size:
                try:
                    ring.stage(ids, src[ids])
                except Exception as e:        # pragma: no cover
                    errs.append(e)

    ts = [threading.Thread(target=stager, args=(s,)) for s in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in ts)
    assert ring.filled <= cap
    live = np.flatnonzero(ring._slot_of >= 0)
    slots = ring._slot_of[live]
    assert np.unique(slots).size == slots.size
    np.testing.assert_array_equal(ring.ids[slots], live)
    out = torch.zeros((live.size, dim))
    hit = ring.gather_into(live, np.arange(live.size), out)
    assert hit.all()
    np.testing.assert_array_equal(out.numpy(), src[live])


def test_ring_stage_filters_staged_ids_and_layouts():
    ring = prefetch.StagingRing(8, 2, np.float32, 32)
    rows = np.arange(8, dtype=np.float32).reshape(4, 2)
    assert ring.stage(np.array([1, 2, 3, 4]), rows) == 4
    assert ring.stage(np.array([2, 3, 9, 4]),
                      np.zeros((4, 2), np.float32)) == 1
    out = torch.full((3, 2), 7.0)
    hit = ring.gather_into(np.array([2, 30, 3]), np.array([0, 1, 2]), out)
    assert hit.tolist() == [True, False, True]
    np.testing.assert_array_equal(out.numpy(),
                                  [[2, 3], [7, 7], [4, 5]])   # miss untouched
    with pytest.raises(ValueError, match="truncate"):
        ring.stage(np.arange(9), np.zeros((9, 2), np.float32))
    with pytest.raises(ValueError, match="capacity"):
        prefetch.StagingRing(0, 2, np.float32, 4)
    # an int8 ring with fp32 sidecars is packed (quant.pack): one buffer
    q = prefetch.StagingRing(4, 100, np.int8, 16, np.float32)
    data, scale, zero = q.table
    assert data.stride(0) == quant.packed_stride(100) == 128
    assert scale.untyped_storage().data_ptr() == \
        data.untyped_storage().data_ptr()
    g = np.random.default_rng(2)
    codes = g.integers(-128, 127, (3, 100)).astype(np.int8)
    sc = g.random((3, 1)).astype(np.float32)
    ze = g.standard_normal((3, 1)).astype(np.float32)
    q.stage(np.array([5, 6, 7]), codes, sc, ze)
    out = torch.zeros((3, 100))
    assert q.gather_into(np.array([7, 5, 6]), np.arange(3), out).all()
    np.testing.assert_array_equal(
        out.numpy(), quant.decode_np(codes, sc, ze)[[2, 0, 1]])


# -- prefetch on and off ------------------------------------------------------

@pytest.mark.parametrize("decode_staged", [True, False])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("ordered", [False, True])
def test_prefetch_on_off_bit_equal(artifact, decode_staged, workers,
                                   ordered):
    _, ref = artifact
    rng = np.random.default_rng(workers + 2 * ordered)
    order = rng.permutation(N) if ordered else None
    off = port_store(artifact, order)
    on = port_store(artifact, order, capacity_rows=256,
                    decode_staged=decode_staged, workers=workers, io_qd=4,
                    io_cap_bytes=256)
    fo = np.asarray(off._order_host()) if ordered else np.arange(N)
    for ids in frontier_batches(rng, 3):
        on.stage_frontier(torch.from_numpy(ids)).result(timeout=30)
        a, b = off[np.abs(ids)], on[np.abs(ids)]
        assert torch.equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(b.numpy(), ref[fo[np.abs(ids)]])
        am, bm = off.getitem_masked(ids), on.getitem_masked(ids)
        assert torch.equal(_bits(am), _bits(bm))
        assert (bm[torch.from_numpy(ids < 0)] == 0).all()
    st = on._cold_prefetch.stats()
    assert st["hit_rows"] > 0 and st["staged_rows"] > 0
    assert st["io"]["extents"] > 0
    off.close()
    on.close()


def test_fp16_disk_under_an_fp32_hot_tier(tmp_path):
    """A ring whose dtype is narrower than the lookup's (an fp16 file
    under an fp32 hot tier, merged at fp32 as JAX merges them): the
    prefetched lookup equals the one without prefetch."""
    g = np.random.default_rng(6)
    feat = g.standard_normal((N, DIM)).astype(np.float32)
    d = str(tmp_path / "f16")
    save_disk_tier(feat, np.arange(N), d, dtype_policy="fp16")
    kw, _ = load_disk_tier(d)
    stores = []
    for pf in ({}, {"capacity_rows": 256}):
        f = Feature(device="cpu").from_mmap(None, DeviceConfig(
            [feat[:CACHE]], None))
        f.set_mmap_file(**kw)
        if pf:
            f.enable_cold_prefetch(**pf)
        stores.append(f)
    ids = g.integers(0, N, 128)
    stores[1].stage_frontier(ids).result(timeout=30)
    a, b = stores[0][ids], stores[1][ids]
    assert b.dtype == torch.float32 and torch.equal(a, b)
    assert stores[1]._cold_prefetch.stats()["hit_rows"] > 0
    for f in stores:
        f.close()


# -- counters and stats against JAX ---------------------------------------------

def _compare(artifact, steps, order=None, **pf):
    t = port_store(artifact, order, **pf)
    j = jax_store(artifact, order, **pf)
    try:
        got, want = _run(t, steps, False), _run(j, steps, True)
        for a, b in zip(got, want):
            assert a[SLOTS].tolist() == b[SLOTS].tolist()
            assert a[:13].tolist() == b[:13].tolist()
        ts, js = t._cold_prefetch.stats(), j._cold_prefetch.stats()
        for k in ("published", "dropped", "batches_staged", "hit_rows",
                  "sync_rows", "staged_rows", "truncated_rows", "hit_rate",
                  "capacity", "filled", "workers"):
            assert ts[k] == js[k], k
        assert ts["io"] == js["io"]
        return got
    finally:
        t.close()
        j.close()


def test_counters_equal_jax_partial_staging(artifact):
    rng = np.random.default_rng(3)
    cold = rng.choice(np.arange(CACHE, N), 64, replace=False)
    hot = rng.integers(0, CACHE, 64)
    got = _compare(artifact, [("lookup", cold), ("publish", cold[:32]),
                              ("lookup", cold), ("publish", hot),
                              ("lookup", hot), ("lookup", cold)],
                   capacity_rows=256, io_qd=1)
    assert got[0][metrics.PREFETCH_SYNC_ROWS] == 64
    assert got[1][metrics.PREFETCH_HIT_ROWS] == 32
    assert got[1][metrics.PREFETCH_STAGED_ROWS] == 32
    assert got[1][metrics.IO_EXTENTS] > 0
    assert got[2][metrics.PREFETCH_HIT_ROWS] == 0      # hot ids: no ring
    d = metrics.derive(got[1])
    assert d["prefetch_hit_rate"] == pytest.approx(0.5)


def test_counters_equal_jax_wrap_and_order(artifact):
    rng = np.random.default_rng(4)
    b1, b2 = np.arange(CACHE, CACHE + 32), np.arange(CACHE + 32, CACHE + 64)
    got = _compare(artifact, [("publish", b1), ("publish", b2),
                              ("lookup", b1), ("lookup", b2)],
                   capacity_rows=32, io_qd=1)
    assert got[0][metrics.PREFETCH_SYNC_ROWS] == 32    # b1 was evicted
    assert got[1][metrics.PREFETCH_HIT_ROWS] == 32
    steps = []
    for ids in frontier_batches(rng, 4):
        steps += [("publish", ids), ("lookup", np.abs(ids))]
    _compare(artifact, steps, order=rng.permutation(N), capacity_rows=96,
             io_qd=1)
    _compare(artifact, steps, capacity_rows=512, io_qd=8,
             io_model=None, io_engine="mmap")


def test_masked_padding_reads_no_disk_row(artifact):
    """A masked lookup's -1 slots read nothing from the disk tier: with
    node 0 stored cold, JAX reads (and counts) node 0's row for each of
    them; the port counts the real cold ids only. The rows agree."""
    _, ref = artifact
    local = np.roll(np.arange(N), -CACHE)       # node 0 at a cold row
    ids = np.array([-1] * 8 + [1, 2, -1])
    got = []
    for store, wrap in ((port_store(artifact, local, capacity_rows=64),
                         np.asarray),
                        (jax_store(artifact, local, capacity_rows=64),
                         jnp.asarray)):
        rows, vec = store.lookup_tiered(wrap(ids), masked=True,
                                        collect_metrics=True)
        got.append((np.asarray(rows), int(np.asarray(vec)[
            metrics.PREFETCH_SYNC_ROWS])))
        store.close()
    order = np.empty(N, np.int64)
    order[local] = np.arange(N)
    want = ref[order[np.clip(ids, 0, N - 1)]] * (ids >= 0)[:, None]
    np.testing.assert_array_equal(got[0][0], want)
    assert got[0][1] == 2 and got[1][1] == 2 + 9


def test_truncation_and_observe_into_equal_jax(artifact, caplog):
    wide = np.arange(CACHE, N)                         # >> 16 slots

    class Hub:
        def __init__(self):
            self.seen = {}

        def observe(self, name, value):
            self.seen[name] = value

    out = []
    for store, ids, name in ((port_store(artifact, capacity_rows=16,
                                         workers=2), wide,
                              "quiver_tpu_torch.prefetch"),
                             (jax_store(artifact, capacity_rows=16,
                                        workers=2), jnp.asarray(wide),
                              "quiver_tpu.prefetch")):
        pf = store._cold_prefetch
        caplog.clear()
        with caplog.at_level(logging.WARNING, name):
            assert pf.publish(ids, block=True).result(timeout=30) == 16
            pf.publish(ids, block=True).result(timeout=30)
        assert len([r for r in caplog.records
                    if "wider than the staging ring" in r.message]) == 1
        hub = Hub()
        d = pf.observe_into(hub)
        d.pop("staged_rows_per_s", None)
        hub.seen.pop("cold_staged_rows_per_s", None)
        out.append((d, hub.seen, pf.stats()["truncated_rows"],
                    pf._ring.filled))
        store.close()
    assert out[0] == out[1]
    assert out[0][0]["truncated_rows"] > 0


def test_dropped_publications_equal_jax(artifact):
    counts = []
    for store, wrap in ((port_store(artifact, capacity_rows=64, depth=1),
                         np.asarray),
                        (jax_store(artifact, capacity_rows=64, depth=1),
                         jnp.asarray)):
        pf = store._cold_prefetch
        gate, release = threading.Event(), threading.Event()

        def hold(*_):
            gate.set()
            release.wait(10)
            return 0

        held = pf._pipe.submit(hold, None)
        assert gate.wait(10)
        queued = pf.publish(wrap(np.arange(CACHE, CACHE + 8)))
        dropped = pf.publish(wrap(np.arange(CACHE + 8, CACHE + 16)))
        assert queued is not None and dropped is None
        release.set()
        assert held.result(10) == 0 and queued.result(10) == 8
        s = pf.stats()
        counts.append((s["published"], s["dropped"], s["staged_rows"],
                       s["pipeline"]["dropped"]))
        store.close()
    assert counts[0] == counts[1] == (2, 1, 8, 1)


@pytest.mark.parametrize("wait", [True, False])
def test_wait_inflight_equal_jax(artifact, wait):
    """A lookup right after a publication whose staging is delayed: with
    ``wait_inflight`` it waits and every cold row is a ring hit, without
    it every cold row is read synchronously; JAX's counts are the same."""
    cold = np.arange(CACHE + 100, CACHE + 140)
    spec = "prefetch.stager:delay,delay_ms=600"
    res = []
    for store, wrap, mod in (
            (port_store(artifact, capacity_rows=128, wait_inflight=wait),
             np.asarray, faults),
            (jax_store(artifact, capacity_rows=128, wait_inflight=wait),
             jnp.asarray, jfaults)):
        store.lookup_tiered(wrap(cold), collect_metrics=True)   # warm up
        mod.install(mod.parse_spec(spec))
        try:
            fut = store.stage_frontier(wrap(cold))
            rows, vec = store.lookup_tiered(wrap(cold), collect_metrics=True)
            fut.result(timeout=30)
        finally:
            mod.disarm()
        vec = np.asarray(vec)
        res.append((int(vec[metrics.PREFETCH_HIT_ROWS]),
                    int(vec[metrics.PREFETCH_SYNC_ROWS])))
        store.close()
    assert res[0] == res[1] == ((40, 0) if wait else (0, 40))


def test_wraparound_under_a_concurrent_stager(artifact):
    """A stager publishing without pause into a ring smaller than two
    publications while the main thread looks up: every lookup is exact."""
    _, ref = artifact
    store = port_store(artifact, capacity_rows=48, workers=2, io_qd=2)
    stop = threading.Event()
    errs = []

    def publisher():
        r = np.random.default_rng(9)
        while not stop.is_set():
            try:
                store._cold_prefetch.publish(
                    r.integers(CACHE, N, 40), block=True).result(timeout=30)
            except Exception as e:                # pragma: no cover
                errs.append(e)
                return

    t = threading.Thread(target=publisher)
    t.start()
    g = np.random.default_rng(10)
    old = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-5)
    try:
        for _ in range(40):
            ids = g.integers(0, N, 64)
            np.testing.assert_array_equal(store[ids].numpy(), ref[ids])
    finally:
        __import__("sys").setswitchinterval(old)
        stop.set()
        t.join(timeout=30)
    assert not errs and not t.is_alive()
    assert store._cold_prefetch.stats()["hit_rows"] > 0
    store.close()


# -- fault sites ----------------------------------------------------------------

def test_dead_stagers_degrade_to_sync_as_jax(artifact):
    _, ref = artifact
    ids = np.arange(CACHE - 20, N, dtype=np.int64)
    stats = []
    for store, wrap, mod in ((port_store(artifact, capacity_rows=512,
                                         workers=2), np.asarray, faults),
                             (jax_store(artifact, capacity_rows=512,
                                        workers=2), jnp.asarray, jfaults)):
        mod.install(mod.parse_spec("prefetch.stager:error,exc=runtime"))
        try:
            fut = store.stage_frontier(wrap(ids))
            with pytest.raises(RuntimeError):
                fut.result(timeout=30)
            rows = np.asarray(store[wrap(ids)])
        finally:
            mod.disarm()
        if mod is faults:
            np.testing.assert_array_equal(rows, ref[ids])
        s = store._cold_prefetch.stats()
        stats.append((s["hit_rows"], s["sync_rows"],
                      s["staging_worker_restarts"]))
        store.close()
    assert stats[0] == stats[1] and stats[0][0] == 0 and stats[0][1] > 0


def test_one_shard_failure_retries_and_counts_as_jax(artifact):
    _, ref = artifact
    ids = np.arange(CACHE, CACHE + 120, dtype=np.int64)
    got = []
    for store, wrap, mod in ((port_store(artifact, capacity_rows=256,
                                         workers=2), np.asarray, faults),
                             (jax_store(artifact, capacity_rows=256,
                                        workers=2), jnp.asarray, jfaults)):
        mod.install(mod.parse_spec("prefetch.stager:error,exc=runtime,"
                                   "times=1"))
        try:
            staged = store.stage_frontier(wrap(ids)).result(timeout=30)
            rows, vec = store.lookup_tiered(wrap(ids), collect_metrics=True)
        finally:
            mod.disarm()
        if mod is faults:
            np.testing.assert_array_equal(rows.numpy(), ref[ids])
        vec = np.asarray(vec)
        got.append((staged, int(vec[metrics.STAGING_RESTARTS]),
                    int(vec[metrics.PREFETCH_HIT_ROWS]),
                    int(vec[metrics.FAULTS_INJECTED])))
        store.close()
    assert got[0] == got[1] == (120, 1, 120, 1)


def test_io_read_retries_reach_the_counters_as_jax(artifact):
    cold = np.arange(CACHE, N, 3)
    spec = "io.read:error,errno=EINTR,rate=0.5"
    steps = [("publish", cold), ("lookup", cold)]
    got = []
    for store, mod, side in ((port_store(artifact, capacity_rows=256,
                                         io_qd=1, io_cap_bytes=64),
                              faults, False),
                             (jax_store(artifact, capacity_rows=256,
                                        io_qd=1, io_cap_bytes=64),
                              jfaults, True)):
        mod.install(mod.parse_spec(spec, seed=3))
        try:
            vec = _run(store, steps, side)[0]
        finally:
            mod.disarm()
        got.append(vec[SLOTS + [metrics.FAULTS_INJECTED]].tolist())
        store.close()
    assert got[0] == got[1]
    assert got[0][SLOTS.index(metrics.IO_RETRIES)] > 0


# -- lifecycle --------------------------------------------------------------------

def test_close_drains_without_stranding_the_worker(artifact):
    f = port_store(artifact, capacity_rows=64, workers=2)
    f.stage_frontier(np.arange(CACHE, CACHE + 64)).result(timeout=30)
    pf = f._cold_prefetch
    gate, release = threading.Event(), threading.Event()

    def slow(_):
        gate.set()
        release.wait(5)
        return 0

    fut = pf._pipe.submit(slow, None)
    assert gate.wait(5)
    queued = pf.publish(np.arange(CACHE, CACHE + 8))
    t = threading.Timer(0.05, release.set)
    t.start()
    f.close()
    t.cancel()
    assert pf.closed and f._cold_prefetch is None
    assert fut.result(timeout=5) == 0
    assert queued is None or queued.cancelled()
    worker = pf._pipe._box["thread"]
    assert worker is None or not worker.is_alive()
    assert not [th for th in threading.enumerate()
                if th.name.startswith(("qt-stager", "qt-io-reader"))
                and th.is_alive()]
    assert f.stage_frontier(np.arange(4)) is None
    with pytest.raises(RuntimeError, match="closed"):
        pf.publish(np.arange(4))
    f.close()


def test_prefetcher_api_edges(artifact):
    kwargs, ref = artifact
    f = port_store(artifact, capacity_rows=64)
    with f._cold_prefetch as pf:
        ids = torch.tensor([-1, 5, CACHE + 3, CACHE + 3, N + 50, -1,
                            CACHE + 7])
        assert f.stage_frontier(ids).result(timeout=30) == 2
        assert "open" in repr(pf)
    assert pf.closed and "closed" in repr(pf)
    pf = f.enable_cold_prefetch(64)
    f.set_mmap_file(**kwargs)            # the ring indexes the old file
    assert f._cold_prefetch is None and pf.closed
    with pytest.raises(ValueError, match="workers"):
        f.enable_cold_prefetch(8, workers=0)
    with pytest.raises(ValueError, match="set_mmap_file first"):
        Feature(device="cpu").enable_cold_prefetch(8)
    # the staging worker clips the order index as the lookup does: a map
    # wider than the order must not fail the publication
    w = port_store(artifact)
    w.set_local_order(np.arange(N))
    import os
    wide = os.path.join(os.path.dirname(kwargs["path"]), "wide_rows.npy")
    np.save(wide, np.zeros((N + 8, DIM), np.float32))
    w.set_mmap_file(wide, np.concatenate([np.arange(N),
                                          np.zeros(8, np.int64)]))
    pf = w.enable_cold_prefetch(64)
    assert pf.publish(np.arange(N, N + 8), block=True).result(30) >= 0
    assert pf._pipe.stats()["failed"] == 0
    w.close()
    f.close()


# -- sample_ahead ---------------------------------------------------------------

def test_sample_ahead_stages_the_frontiers(artifact):
    _, ref = artifact
    f = port_store(artifact, capacity_rows=256)

    class StubSampler:
        def __init__(self):
            self.calls = []

        def sample(self, seeds):
            self.calls.append(int(seeds[0]))
            return (torch.cat([torch.as_tensor(seeds),
                               torch.arange(CACHE, CACHE + 8)]),
                    len(seeds), "adjs")

    s = StubSampler()
    got = list(sample_ahead(s, [np.array([i, i + 1]) for i in range(0, 8, 2)],
                            f))
    assert [int(g[0][0]) for g in got] == [0, 2, 4, 6] == s.calls
    deadline = time.time() + 10
    while f._cold_prefetch.stats()["staged_rows"] < 8 \
            and time.time() < deadline:
        time.sleep(0.01)
    assert f._cold_prefetch.stats()["staged_rows"] == 8
    f.close()

    f = port_store(artifact, capacity_rows=1024)
    g = np.random.default_rng(5)
    indptr = np.arange(0, 4 * (N + 1), 4)
    indices = g.integers(0, N, 4 * N).astype(np.int32)
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    seeds = [torch.from_numpy(g.integers(0, N, 16).astype(np.int32))
             for _ in range(4)]
    want = [GraphSageSampler(topo, [3, 2], seed=1, device="cpu").sample(b)
            for b in seeds[:1]]
    outs = list(sample_ahead(GraphSageSampler(topo, [3, 2], seed=1,
                                              device="cpu"), seeds, f))
    assert torch.equal(outs[0][0], want[0][0])
    for n_id, bs, _ in outs:
        assert bs == 16
        rows = f.getitem_masked(n_id)
        valid = (n_id >= 0).numpy()
        np.testing.assert_array_equal(rows.numpy()[valid],
                                      ref[n_id.numpy()[valid]])
    st = f._cold_prefetch.stats()
    assert st["published"] == 4 and st["staged_rows"] > 0
    assert st["hit_rows"] > 0
    f.close()


# -- CUDA events go on the ids' device's stream ----------------------------------

class _Recorder:
    """Stand-ins for ``torch.cuda.Event`` and ``current_stream``: each
    record names the stream it was given."""

    def __init__(self, monkeypatch):
        self.recorded = []
        rec = self

        class Event:
            def __init__(self, *a, **k):
                pass

            def record(self, stream=None):
                rec.recorded.append(stream)

            def synchronize(self):
                pass

            def query(self):
                return True

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: ("stream of", device))


CARD1 = torch.device("cuda", 1)


class _CardIds:
    """Ids that say they live on the second card."""

    device = CARD1
    is_cuda = True
    shape = (4,)
    dtype = torch.int32

    def clone(self):
        return self

    def record_stream(self, stream):
        pass


def test_prefetch_event_is_recorded_on_the_ids_device(monkeypatch):
    rec = _Recorder(monkeypatch)
    f = Feature(device="cpu").from_cpu_tensor(np.zeros((8, 4), np.float32))
    monkeypatch.setattr(Feature, "_ids", lambda self, x: _CardIds())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "worker stream")
    submitted = []
    f._pool = types.SimpleNamespace(
        submit=lambda fn, *args: submitted.append(args))
    f.prefetch([0, 1, 2, 3])
    assert rec.recorded == [("stream of", CARD1)]
    assert submitted and submitted[0][0].device == CARD1


def test_mixed_device_event_is_recorded_on_the_ids_device(monkeypatch):
    rec = _Recorder(monkeypatch)
    out = (_CardIds(), 4, [])
    fake = types.SimpleNamespace(
        device_sampler=types.SimpleNamespace(sample=lambda seeds: out),
        _ema=lambda old, dt: dt, _device_time=None,
        tasks={"device": 0})
    assert MixedGraphSageSampler._device_one(fake, [0]) is out
    assert rec.recorded == [("stream of", CARD1)]


def test_prefetcher_events_are_recorded_on_the_ids_device(monkeypatch):
    rec = _Recorder(monkeypatch)

    class Host:
        def copy_(self, src, non_blocking=False):
            assert non_blocking
            return self

    class Ids(_CardIds):
        pass

    monkeypatch.setattr(torch, "is_tensor", lambda x: True)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: Host())
    host, ready = prefetch._snapshot(Ids())
    assert isinstance(host, Host) and ready is not None
    assert rec.recorded == [("stream of", CARD1)]
    monkeypatch.undo()
    rec = _Recorder(monkeypatch)
    ring = prefetch.StagingRing(4, 2, np.float32, 8)
    ring._fence(CARD1, np.array([0, 1]))
    assert rec.recorded == [("stream of", CARD1)]
    assert ring._reader[:2].tolist() == [1, 1]
