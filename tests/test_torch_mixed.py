"""``GraphSageSampler(mode="CPU")`` and ``MixedGraphSageSampler`` of the
port (``quiver_tpu_torch/pyg/sage_sampler.py``) on the CPU.

CPU mode is held bit for bit to the JAX package's CPU mode given the same
engine seed: the port draws its seed from the sampler's host generator,
and the JAX sampler is handed that seed in place of its key draw. Both
then run the same C++ engine (``tests/test_torch_native.py``), so
``n_id``, every ``edge_index``, ``e_id`` (through the COO edge-id map)
and the weighted draw agree exactly.

The mixed sampler is held to its contract: every batch of the job once,
each batch a valid sample (graph edges, ``min(deg, k)`` per target,
distinct picks), the device side never waiting for a slow host task (no
round barrier), the task split of the JAX class for the same measured
times, ``close``, the IPC handle, the refusal of weighted windowed
sampling and the reshuffle at each epoch boundary."""

import threading

import jax
import numpy as np
import pytest
import torch

import quiver_tpu as jqv
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.pyg.sage_sampler import \
    MixedGraphSageSampler as JMixed
from quiver_tpu_torch import (CSRTopo, GraphSageSampler,
                              MixedGraphSageSampler, SampleJob)

N = 300
SIZES = [4, 3, 2]


@pytest.fixture(scope="module")
def coo():
    g = np.random.default_rng(3)
    deg = np.minimum(g.lognormal(1.5, 1.0, N).astype(np.int64), 400)
    deg[:4] = 0
    src = np.repeat(np.arange(N), deg)
    dst = g.integers(0, N, src.shape[0])
    perm = g.permutation(src.shape[0])       # COO order != CSR order
    return np.stack([src[perm], dst[perm]])


@pytest.fixture(scope="module")
def topos(coo):
    return (CSRTopo(edge_index=coo, node_count=N, device="cpu"),
            jqv.CSRTopo(edge_index=coo, node_count=N))


def _engine_seed(seed: int) -> int:
    """The engine seed the port's sampler draws first from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return int(torch.randint(0, 2**31 - 1, (), generator=g))


def _seeds(n=20, seed=0):
    g = np.random.default_rng(seed)
    s = g.permutation(N)[:n].astype(np.int32)
    s[5] = -1
    return s


@pytest.mark.parametrize("with_eid", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_cpu_mode_equals_jax_cpu_mode(topos, coo, monkeypatch, weighted,
                                      with_eid):
    ours_t, theirs_t = topos
    assert np.array_equal(ours_t.eid.numpy(), np.asarray(theirs_t.eid))
    w = np.random.default_rng(1).random(coo.shape[1]).astype(np.float32)
    kw = dict(mode="CPU", with_eid=with_eid,
              edge_weight=w if weighted else None)
    ours = GraphSageSampler(ours_t, SIZES, device="cpu", seed=5, **kw)
    theirs = JSampler(theirs_t, SIZES, seed=5, **kw)
    seeds = _seeds()
    engine_seed = _engine_seed(5)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: engine_seed)
    n_id, bs, adjs = ours.sample(seeds)
    jn_id, jbs, jadjs = theirs.sample(seeds)
    assert bs == jbs == seeds.shape[0]
    assert n_id.dtype == torch.int32
    assert np.array_equal(n_id.numpy(), np.asarray(jn_id))
    assert len(adjs) == len(jadjs) == len(SIZES)
    for a, b in zip(adjs, jadjs):
        assert a.size == b.size
        assert a.edge_index.dtype == torch.int32
        assert np.array_equal(a.edge_index.numpy(), np.asarray(b.edge_index))
        assert np.array_equal(a.mask.numpy(), np.asarray(b.mask))
        if with_eid:
            assert np.array_equal(a.e_id.numpy(), np.asarray(b.e_id))
        else:
            assert a.e_id is None and b.e_id is None
    assert ours.last_counters is None


def test_cpu_mode_edges_name_coo_edges(topos, coo):
    """Each sampled edge's e_id is the COO edge from its target to its
    source; per target ``min(deg, k)`` distinct edges."""
    topo = topos[0]
    s = GraphSageSampler(topo, SIZES, device="cpu", mode="CPU",
                         with_eid=True, sampling="rotation", seed=2)
    assert s.sampling == "exact"            # windowed falls back
    seeds = _seeds(30, 4)
    n_id, bs, adjs = s.sample(seeds)
    _check_contract(topo, coo, n_id, bs, adjs, int((seeds >= 0).sum()))


def _check_contract(topo, coo, n_id, bs, adjs, n_valid=None):
    """``n_valid``: the valid seeds, which the compaction puts first."""
    indptr = topo.indptr.numpy()
    n_id = n_id.cpu().numpy()
    n_valid = bs if n_valid is None else n_valid
    for adj, k in zip(adjs[::-1], SIZES):
        ei = adj.edge_index.cpu().numpy()
        m = adj.mask.cpu().numpy()
        src, dst = ei[0][m], ei[1][m]
        t, u = n_id[dst], n_id[src]
        if adj.e_id is not None:
            e = adj.e_id.cpu().numpy()[m]
            assert np.array_equal(coo[0, e], t) and np.array_equal(coo[1, e],
                                                                   u)
            assert np.unique(e).size == e.size
        seeds = n_id[:n_valid]
        ok = seeds >= 0
        deg = np.where(ok, indptr[np.maximum(seeds, 0) + 1]
                       - indptr[np.maximum(seeds, 0)], 0)
        cnt = np.bincount(dst, minlength=adj.size[1])
        assert np.array_equal(cnt[:n_valid], np.minimum(deg, k))
        n_valid = int(src.max()) + 1 if src.size else n_valid


def test_cpu_mode_placement_and_aux(topos):
    s = GraphSageSampler(topos[0], SIZES, device="cpu", mode="CPU", seed=1)
    assert s.generator.device.type == "cpu"
    s.lazy_init_quiver()
    indptr, indices = s._placed
    assert indptr.dtype == torch.int64 and indices.dtype == torch.int32
    nbrs, counts = s.sample_layer(_seeds(8), 3)
    assert nbrs.shape == (8, 3) and counts.shape == (8,)
    p = s.sample_prob(np.arange(10), N)
    ref = GraphSageSampler(topos[0], SIZES, device="cpu").sample_prob(
        np.arange(10), N)
    assert torch.equal(p, ref)
    assert s.share_ipc()[2] == "CPU"
    back = GraphSageSampler.lazy_from_ipc_handle(s.share_ipc())
    assert back.mode == "CPU" and back.sizes == SIZES


class _Job(SampleJob):
    def __init__(self, batches, shuffles=None):
        self.batches = batches
        self.shuffles = shuffles if shuffles is not None else []

    def __getitem__(self, i):
        return self.batches[i]

    def __len__(self):
        return len(self.batches)

    def shuffle(self):
        self.shuffles.append(1)


def _job(n_batches=24, bs=12, seed=0):
    perm = np.random.default_rng(seed).permutation(N).astype(np.int32)
    return _Job([perm[i * bs:(i + 1) * bs] for i in range(n_batches)])


@pytest.mark.parametrize("device_mode", ["HBM", "HOST"])
@pytest.mark.parametrize("workers", [1, 3])
def test_mixed_yields_every_batch_once(topos, coo, device_mode, workers):
    job = _job()
    m = MixedGraphSageSampler(job, SIZES, topos[0], device="cpu",
                              device_mode=device_mode, num_workers=workers,
                              with_eid=True)
    try:
        outs = list(m)
    finally:
        m.close()
    assert len(outs) == len(job)
    got = sorted(tuple(o[0][:o[1]].tolist()) for o in outs)
    assert got == sorted(tuple(b.tolist()) for b in job.batches)
    for o in outs:
        _check_contract(topos[0], coo, *o)
    assert m.tasks["device"] + m.tasks["cpu"] == len(job)
    assert m.tasks["cpu"] >= 1 and len(job.shuffles) == 1


def test_mixed_weighted(topos, coo):
    w = np.random.default_rng(2).random(coo.shape[1]).astype(np.float32)
    w[::3] = 0
    m = MixedGraphSageSampler(_job(10), SIZES, topos[0], device="cpu",
                              edge_weight=w, with_eid=True)
    outs = list(m)
    m.close()
    assert len(outs) == 10
    for n_id, bs, adjs in outs:
        for adj in adjs:
            e = adj.e_id[adj.mask].numpy()
            assert (w_at(topos[0], w, e) > 0).all()   # no zero-weight pick


def w_at(topo, w, eids):
    """The weight of COO edges ``eids`` where ``w`` is CSR-slot-aligned."""
    slot_of = np.empty_like(topo.eid.numpy())
    slot_of[topo.eid.numpy()] = np.arange(slot_of.shape[0])
    return w[slot_of[eids]]


def test_mixed_has_no_round_barrier(topos):
    """Host tasks block until ten device batches came out: a scheduler
    that waited for the host round would never get there."""
    job = _job(30)
    m = MixedGraphSageSampler(job, SIZES, topos[0], device="cpu",
                              num_workers=2)
    release = threading.Event()
    orig = m.cpu_sampler.sample

    def slow(seeds):
        assert release.wait(20), "the device side waited for the host"
        return orig(seeds)

    m.cpu_sampler.sample = slow
    it = iter(m)
    try:
        first = [next(it) for _ in range(10)]
        assert m.tasks == {"device": 10, "cpu": 0}
        release.set()
        rest = list(it)
    finally:
        release.set()
        m.close()
    assert len(first) + len(rest) == 30 and m.tasks["cpu"] >= 1


def test_mixed_task_split_matches_jax(topos):
    ours = MixedGraphSageSampler(_job(), SIZES, topos[0], device="cpu",
                                 num_workers=3)
    theirs = JMixed(_job(), SIZES, topos[1], num_workers=3)
    assert ours.EMA_ALPHA == theirs.EMA_ALPHA
    for dev_t, cpu_t in ((None, None), (0.01, None), (0.01, 0.02),
                         (0.002, 0.5), (0.5, 0.001)):
        for m in (ours, theirs):
            m._device_time, m._cpu_time = dev_t, cpu_t
        assert ours.decide_task_num() == theirs.decide_task_num()
    for m in (ours, theirs):
        m._device_time = None
        for dt in (0.1, 0.3, 0.2):
            m._device_time = m._ema(m._device_time, dt)
    assert ours._device_time == theirs._device_time


def test_mixed_close_and_ipc(topos):
    m = MixedGraphSageSampler(_job(8), SIZES, topos[0], device="cpu",
                              num_workers=2, sampling="rotation")
    list(m)
    m.close()
    m.close()                                  # idempotent
    assert not [t for t in threading.enumerate()
                if t.name.startswith("quiver-mixed-cpu")]
    assert len(list(m)) == 8                   # a new pool after close
    m.close()
    h = m.share_ipc()
    back = MixedGraphSageSampler.lazy_from_ipc_handle(h)
    assert (back.sizes, back.num_workers, back.device_sampler.mode,
            back.device_sampler.sampling) == (SIZES, 2, "HBM", "rotation")
    old = MixedGraphSageSampler.lazy_from_ipc_handle(h[:6])
    assert old.device_sampler.sampling == "exact"
    assert old.cpu_sampler.mode == "CPU"


def test_mixed_refuses_weighted_windowed(topos, coo):
    w = np.ones(coo.shape[1], np.float32)
    with pytest.raises(ValueError, match="pins sampling='exact'"):
        MixedGraphSageSampler(_job(), SIZES, topos[0], device="cpu",
                              edge_weight=w, sampling="rotation")


def test_mixed_reshuffles_each_epoch(topos):
    m = MixedGraphSageSampler(_job(6), SIZES, topos[0], device="cpu",
                              sampling="rotation", num_workers=1)
    calls = []
    orig = m.device_sampler.reshuffle
    m.device_sampler.reshuffle = lambda *a: (calls.append(1), orig(*a))[1]
    list(m)
    first = len(calls)                 # the first sample's own reshuffle
    list(m)
    list(m)
    m.close()
    assert first == 1 and len(calls) == 3
