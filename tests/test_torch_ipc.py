"""Sharing stores with ``torch.multiprocessing`` workers, on the CPU:
``Feature.share_ipc`` / ``new_from_ipc_handle`` /
``lazy_from_ipc_handle`` + ``lazy_init_from_ipc_handle`` (JAX's handle
tuple, ``quiver_tpu/feature.py:1177-1190``), and the ``ForkingPickler``
reducers that ``import quiver_tpu_torch.multiprocessing`` registers for
``Feature`` and ``ShardTensor`` (the capability of JAX
``multiprocessing/reductions.py``). A spawned worker's lookups equal
the parent's bit for bit; the tiers cross as shared memory, not as
copies (the parent's tiers are moved into shared memory, and the
worker's tensors map the same pages). Plain ``pickle`` keeps copying.

This module imports no JAX: the spawned workers import it."""

import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import quiver_tpu_torch.multiprocessing  # noqa: F401  (the reducers)
from quiver_tpu_torch import CSRTopo, Feature, ShardTensor
from quiver_tpu_torch.parallel import make_mesh

N, DIM = 300, 12
TIMEOUT = 120


def _graph():
    g = np.random.default_rng(0)
    deg = g.integers(0, 12, N)
    indptr = np.zeros(N + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    return indptr, g.integers(0, N, indptr[-1]).astype(np.int32)


def _ids():
    ids = np.random.default_rng(5).integers(0, N, 64)
    ids[::7] = -1
    return torch.from_numpy(ids)


def _lookups(store, ids):
    if isinstance(store, ShardTensor):
        return store[ids]
    return store.getitem_masked(ids)


def _worker(kind, obj, ids, out):
    """In the spawned process: open the store, look ``ids`` up, send
    the rows back with whether its tiers lie in shared memory."""
    try:
        if kind == "handle":
            store = Feature.new_from_ipc_handle(1, obj)
        elif kind == "lazy":
            store = Feature.lazy_from_ipc_handle(obj)
            store.lazy_init_from_ipc_handle()
        else:
            store = obj
        shared = all(t.is_shared() for t in _tensors(store))
        out.put(("ok", _lookups(store, ids).numpy(), shared,
                 getattr(store, "rank", None)))
    except Exception as e:                  # reported to the parent
        out.put(("error", repr(e), None, None))


def _tensors(store):
    from quiver_tpu_torch.ops import quant
    if isinstance(store, ShardTensor):
        tiers = store._blocks
    else:
        tiers = [store.device_part, store._host_offload, store.host_part]
    out = []
    for t in tiers:
        if t is None:
            continue
        parts = t.shards if quant.is_sharded(t) else [t]
        for p in parts:
            out += [x for x in quant.tier_parts(p) if x is not None]
    return out


def _in_worker(kind, obj, ids):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_worker, args=(kind, obj, ids, out))
    proc.start()
    try:
        status, rows, shared, rank = out.get(timeout=TIMEOUT)
    finally:
        proc.join(timeout=TIMEOUT)
        if proc.is_alive():
            proc.kill()
    assert status == "ok", rows
    return torch.from_numpy(rows), shared, rank


def _store(policy, sharded):
    indptr, indices = _graph()
    feat = np.random.default_rng(1).standard_normal((N, DIM)) \
        .astype(np.float32)
    kw = dict(device_cache_size=120 * DIM * 4, dtype_policy=policy,
              host_placement="offload", device="cpu",
              csr_topo=CSRTopo(indptr=indptr, indices=indices,
                               device="cpu"))
    if sharded:
        kw.update(device_cache_size=30 * DIM * 4,
                  cache_policy="p2p_clique_replicate",
                  mesh=make_mesh(("cache",), devices=["cpu"] * 4))
    store = Feature(**kw).from_cpu_tensor(feat)
    assert store.sharded == sharded and store._host_offload is not None
    return store


@pytest.mark.parametrize("kind", ["handle", "lazy", "reducer"])
@pytest.mark.parametrize("policy,sharded", [(None, False), ("int8", True)],
                         ids=["fp32", "int8_clique"])
def test_worker_lookups_equal_the_parents(kind, policy, sharded):
    store = _store(policy, sharded)
    ids = _ids()
    want = _lookups(store, ids)
    handle = store.share_ipc()
    assert handle[:5] == (store.rank, store.device_list,
                          store.device_cache_size, store.cache_policy,
                          store.csr_topo)
    # the cold tier now lies in shared memory: the same rows
    cold = store._host_offload
    assert all(t.is_shared() for t in (cold if policy else [cold]))
    assert torch.equal(_lookups(store, ids), want)
    obj = store if kind == "reducer" else handle
    got, shared, rank = _in_worker(kind, obj, ids)
    assert torch.equal(got, want) and shared
    assert rank == (1 if kind == "handle" else 0)


@pytest.mark.parametrize("policy", [None, "int8"], ids=str)
def test_shard_tensor_crosses_by_its_reducer(policy):
    g = np.random.default_rng(2)
    st = ShardTensor(0, dtype_policy=policy, device="cpu")
    for rows, dev in ((40, 0), (30, -1), (20, 1), (10, -1)):
        st.append(g.standard_normal((rows, DIM)).astype(np.float32), dev)
    ids = torch.from_numpy(g.integers(-2, 105, 80))
    want = st[ids]
    got, shared, _ = _in_worker("reducer", st, ids)
    assert torch.equal(got, want) and shared


def test_plain_pickle_still_copies():
    """``pickle`` (not ``ForkingPickler``) keeps the store's own
    ``__getstate__``: tensors go out as bytes and come back as new
    memory; a sharded store is sharded again on load."""
    store = _store("int8", True)
    u = pickle.loads(pickle.dumps(store))
    ids = _ids()
    assert torch.equal(u.getitem_masked(ids), store.getitem_masked(ids))
    assert u.sharded and u._host_offload is not None
    assert not u._host_offload.data.is_shared()


def test_disk_store_is_refused(tmp_path):
    store = _store(None, False)
    path = tmp_path / "rows.npy"
    np.save(path, np.zeros((N, DIM), np.float32))
    store.set_mmap_file(str(path), np.arange(N))
    with pytest.raises(ValueError, match="disk-tier"):
        store.share_ipc()


class _Cudart:
    """A stand-in for ``torch.cuda.cudart()`` that records its calls."""

    def __init__(self):
        self.calls = []

    def cudaHostRegister(self, ptr, nbytes, flags):
        self.calls.append(("register", ptr, nbytes))
        return 0

    def cudaHostUnregister(self, ptr):
        self.calls.append(("unregister", ptr))
        return 0


@pytest.mark.parametrize("policy", [None, "int8"])
def test_a_shared_tier_stays_registered_while_any_view_lives(policy,
                                                             monkeypatch):
    """``share_host`` for a card registers each storage of the tier once,
    and undoes that registration when the last tensor on the storage is
    freed, not before: the CUDA driver keeps a registration past the
    unmapping of its pages, and a later allocation at those addresses
    would be read from the old pages."""
    import gc
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.utils import placement
    cudart = _Cudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    table = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N, DIM)).astype(np.float32))
    tier = placement.pinned_put(quant.quantize(table, policy),
                                torch.device("cpu"), "the tier") \
        if policy else table
    shared = placement.share_host(tier, torch.device("cuda", 0))
    regs = [c for c in cudart.calls if c[0] == "register"]
    assert len(regs) == 1 and cudart.calls == regs
    view = quant.tier_parts(shared)[0][5:]
    del shared, tier
    gc.collect()
    assert cudart.calls == regs
    del view
    gc.collect()
    assert cudart.calls == regs + [("unregister", regs[0][1])]
