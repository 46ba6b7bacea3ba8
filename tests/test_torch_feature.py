"""The port's tiered ``Feature`` store (``quiver_tpu_torch/feature.py``)
against the JAX package's (``quiver_tpu/feature.py``) on the same numpy
tables, on the CPU.

Construction is compared exactly: hot-row counts, ``feature_order`` and
both tiers' stored bits, for fp32, bf16, int8 and bf16-hot + int8-cold
stores. Lookups are compared against JAX's jitted ``_lookup_tiered`` (the port
of ``tests/test_feature.py``'s offload lookup tests), through the port's
``__getitem__``, ``getitem_masked`` and ``_lookup_tiered``, for both host
placements: ``"offload"`` runs the port's predicated tiered lookup (the
row gather's plain version here), ``"numpy"`` its host path.

Rounding of the int8 decode ``code * scale + zero``: the port rounds the
multiply and then the add everywhere, as the Pallas kernels do (and so
as its CUDA kernels must, to equal them). XLA on the CPU contracts the
jitted lookup's decode into one fused multiply-add, and JAX's numpy host
path decodes through float64 and rounds once too. So a store with an
int8 tier is held bit for bit to JAX's jitted lookup over the same tiers
decoded by numpy with two roundings (every branch's selection exact),
and to JAX's own int8 lookup within one rounding of the product
``code * scale`` (``ONE_ROUNDING``). fp32 and bf16 stores are held bit
for bit to JAX's own lookup."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu.ops import quant as jquant
from quiver_tpu.utils import reorder as jreorder
from quiver_tpu_torch import CSRTopo, DeviceConfig, Feature, parse_size
from quiver_tpu_torch import feature as tfeature
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.utils import reorder

N, DIM = 200, 8
POLICIES = [None, "bf16", "int8", {"hot": "bf16", "cold": "int8"}]
PLACEMENTS = ["offload", "numpy"]
# half an ulp of a product below 8 in magnitude (|code * scale| stays
# under the largest |feature| of these standard-normal tables) is 2**-22;
# this allows one such rounding with room to spare
ONE_ROUNDING = 2.0 ** -20


def _graph(n=N, seed=0):
    g = np.random.default_rng(seed)
    deg = g.integers(0, 20, n)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, n, indptr[-1]).astype(np.int32)
    return indptr, indices


def _table(n=N, dim=DIM, seed=1):
    return np.random.default_rng(seed).standard_normal((n, dim)) \
        .astype(np.float32)


def _bits(a):
    """The stored bits of a numpy array, a jax array or a tensor."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _same(a, b):
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _leaves(t):
    return list(t) if quant.is_quantized(t) or jquant.is_quantized(t) \
        else [t]


def _stores(feat, placement="offload", topo=True, **kw):
    """The JAX store and the port's over ``feat`` (with a csr_topo from
    the same graph when ``topo``)."""
    jkw, tkw = dict(kw), dict(kw)
    if topo:
        indptr, indices = _graph(feat.shape[0])
        jkw["csr_topo"] = qv.CSRTopo(indptr=indptr, indices=indices)
        tkw["csr_topo"] = CSRTopo(indptr=indptr, indices=indices,
                                  device="cpu")
    j = qv.Feature(**jkw)
    j.from_cpu_tensor(feat)
    t = Feature(host_placement=placement, device="cpu", **tkw)
    t.from_cpu_tensor(feat)
    return j, t


def _cold_tier(t):
    return t._host_offload if t._host_offload is not None else t.host_part


def _jax_lookup(j, ids, masked=False):
    host = jquant.tree_map_tier(jnp.asarray, j.host_part)
    return np.asarray(j._lookup_tiered(j.device_part, host,
                                       jnp.asarray(ids), j.feature_order,
                                       masked))


def _decoded(tier):
    """A JAX store's tier as fp32 rows, an int8 tier decoded by numpy
    with a rounded multiply, then a rounded add."""
    if jquant.is_quantized(tier):
        return np.asarray(tier.data).astype(np.float32) \
            * np.asarray(tier.scale) + np.asarray(tier.zero)
    return np.asarray(tier).astype(np.float32)


def _exact_reference(j):
    """``j`` itself, or, when a tier is int8, a JAX store with the same
    knobs and order over its tiers as :func:`_decoded` rows."""
    tiers = [p for p in (j.device_part, j.host_part) if p is not None]
    if not any(jquant.is_quantized(p) for p in tiers):
        return j
    jx = qv.Feature(device_cache_size=j.cache_rows * DIM * 4,
                    cold_budget=j.cold_budget, dedup_cold=j.dedup_cold)
    jx.from_cpu_tensor(np.concatenate([_decoded(p) for p in tiers]))
    assert jx.cache_rows == j.cache_rows
    jx.feature_order = j.feature_order
    return jx


def _check_one(j, jx, got, ids, masked=False, signed_zeros=True):
    want = _jax_lookup(jx, ids, masked)
    if not signed_zeros:
        got = torch.where(got == 0, torch.zeros_like(got), got)
        want = np.where(want == 0, np.zeros_like(want), want)
    assert _same(got, want)
    if jx is not j:
        np.testing.assert_allclose(got.numpy(), _jax_lookup(j, ids, masked),
                                   rtol=0, atol=ONE_ROUNDING)


def _check_lookups(j, t, ids):
    """The port's lookups against JAX's jitted tiered lookup (see the
    module's note on rounding)."""
    jx = _exact_reference(j)
    _check_one(j, jx, t[ids], ids)
    _check_one(j, jx, t._lookup_tiered(t.device_part, _cold_tier(t),
                                       torch.from_numpy(ids),
                                       t.feature_order), ids)
    masked = ids.copy()
    masked[::7] = -1
    # the host path masks by a multiply, as JAX's host path does, so a
    # padding row may hold -0.0 where the dedup lookup expands +0.0
    signed = t.host_placement == "offload"
    _check_one(j, jx, t.getitem_masked(masked), masked, True, signed)
    _check_one(j, jx, t.lookup_tiered(masked, masked=True), masked, True,
               signed)


def _ids_by_tier(t, rng, n_hot, n_cold):
    """Node ids whose storage rows are hot / cold, shuffled."""
    order = t.feature_order.numpy() if t.feature_order is not None \
        else np.arange(t.size(0))
    hot = np.flatnonzero(order < t.cache_rows)
    cold = np.flatnonzero(order >= t.cache_rows)
    ids = np.concatenate([rng.choice(hot, n_hot), rng.choice(cold, n_cold)
                          if n_cold else np.empty(0, np.int64)])
    rng.shuffle(ids)
    return ids.astype(np.int64)


# -- construction -------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_construction_matches_jax(policy):
    feat = _table()
    j, t = _stores(feat, device_cache_size=70 * DIM * 4,
                   dtype_policy=policy)
    assert t.cache_rows == j.cache_rows and 0 < t.cache_rows < N
    assert np.array_equal(t.feature_order.numpy(),
                          np.asarray(j.feature_order))
    for got, want in ((t.device_part, j.device_part),
                      (_cold_tier(t), j.host_part)):
        assert len(_leaves(got)) == len(_leaves(want))
        for g, w in zip(_leaves(got), _leaves(want)):
            assert _same(g, w)
    assert t.shape == tuple(j.shape) == (N, DIM)
    assert t.size(0) == N and t.dim() == DIM


def test_offload_on_the_cpu_keeps_plain_tensors():
    t = Feature(device_cache_size=50 * DIM * 4, host_placement="offload",
                device="cpu").from_cpu_tensor(_table())
    assert t.host_part is None and t._host_offload.device.type == "cpu"
    n = Feature(device_cache_size=50 * DIM * 4, device="cpu") \
        .from_cpu_tensor(_table())
    assert n._host_offload is None and n.host_part.shape == (N - 50, DIM)


def test_reindex_matches_jax():
    indptr, indices = _graph()
    jtopo = qv.CSRTopo(indptr=indptr, indices=indices)
    ttopo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    feat = _table()
    for portion, seed in ((0.0, 0), (0.3, 5)):
        jf, jo = jreorder.reindex_feature(jtopo, feat, portion, seed=seed)
        tf, to = reorder.reindex_feature(ttopo, feat, portion, seed=seed)
        assert np.array_equal(to, jo) and np.array_equal(tf, jf)


def test_shared_topo_reuses_the_order():
    """A second store over a topo whose ``feature_order`` is set permutes
    its own table by it (``feature.py:204-213``)."""
    indptr, indices = _graph()
    jtopo = qv.CSRTopo(indptr=indptr, indices=indices)
    ttopo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    a, b = _table(seed=2), _table(seed=3)
    stores = []
    for topo, cls, kw in ((jtopo, qv.Feature, {}),
                          (ttopo, Feature, {"device": "cpu"})):
        first = cls(device_cache_size=20 * DIM * 4, csr_topo=topo, **kw)
        first.from_cpu_tensor(a)
        second = cls(device_cache_size=30 * DIM * 4, csr_topo=topo, **kw)
        second.from_cpu_tensor(b)
        stores.append(second)
    j, t = stores
    ids = np.arange(N)
    assert _same(t[ids], np.asarray(j[jnp.asarray(ids)]))
    assert np.array_equal(t[ids].numpy(), b)


def test_from_mmap_device_config_matches_jax():
    feat = _table()
    j, t = qv.Feature(), Feature(device="cpu")
    j.from_mmap(None, qv.DeviceConfig([feat[:40], feat[40:70]], feat[70:]))
    t.from_mmap(None, DeviceConfig([feat[:40], torch.from_numpy(feat[40:70])],
                                   feat[70:]))
    assert t.cache_rows == j.cache_rows == 70
    assert _same(t.device_part, j.device_part)
    assert _same(t.host_part, j.host_part)
    ids = np.array([0, 69, 70, 199, 5, 150])
    assert np.array_equal(t[ids].numpy(), feat[ids])
    # only np_array: everything cold
    t2 = Feature(device="cpu").from_mmap(
        feat, DeviceConfig([], np.zeros((0, DIM), np.float32)))
    assert t2.cache_rows == 0 and t2.device_part is None
    assert np.array_equal(t2[ids].numpy(), feat[ids])


@pytest.mark.parametrize("size", [0, 1024, 2.5, "200M", "4 GB", "1.5k",
                                  "64KB", "7"])
def test_parse_size_matches_jax(size):
    assert parse_size(size) == qv.utils.parse_size(size)


def test_parse_size_refuses_what_jax_refuses():
    for bad in ("12XB", "lots", None):
        with pytest.raises(ValueError):
            qv.utils.parse_size(bad)
        with pytest.raises(ValueError):
            parse_size(bad)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_cal_size_matches_jax(policy):
    feat = _table(n=1000, dim=100)
    j, t = qv.Feature(dtype_policy=policy), Feature(dtype_policy=policy,
                                                    device="cpu")
    for budget in (0, 999, parse_size("64K"), 10**9):
        assert t.cal_size(feat, budget) == j.cal_size(feat, budget)
        assert t.cal_size(torch.from_numpy(feat), budget) == \
            j.cal_size(feat, budget)
        assert [p.shape for p in t.partition(feat, budget)] == \
            [p.shape for p in j.partition(feat, budget)]


# -- lookups, bit for bit against JAX's jitted lookup -------------------------


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_budgeted_lookup_across_the_budget(placement, policy):
    """Cold counts 0, 3, 8, 9 and 20 at ``cold_budget=8``: the narrow
    path, its boundary and the full-gather fallback."""
    feat = _table()
    j, t = _stores(feat, placement, device_cache_size=100 * 12,
                   cold_budget=8, dtype_policy=policy)
    rng = np.random.default_rng(3)
    for cold_count in (0, 3, 8, 9, 20):
        _check_lookups(j, t, _ids_by_tier(t, rng, 32 - cold_count,
                                          cold_count))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("policy", ["int8", {"hot": "bf16", "cold": "int8"}],
                         ids=str)
def test_offload_int8_tier_is_packed(policy, dedup):
    """The offload store's int8 cold tier is packed on the CPU too (one
    buffer in ``quant.pack``'s layout), holds JAX's bits, and answers
    every branch equal to JAX."""
    feat = _table()
    j, t = _stores(feat, "offload", device_cache_size=100 * 12,
                   cold_budget=8, dedup_cold=dedup, dtype_policy=policy)
    cold = _cold_tier(t)
    buf = cold.data.untyped_storage().data_ptr()
    assert cold.data.stride(0) == quant.packed_stride(DIM)
    assert all(x.untyped_storage().data_ptr() == buf for x in cold)
    assert cold.scale.data_ptr() - cold.data.data_ptr() \
        == quant.sidecar_offset(DIM)
    for g, w in zip(cold, j.host_part):
        assert _same(g, w)
    rng = np.random.default_rng(17)
    for cold_count in (0, 3, 8, 9, 20):
        _check_lookups(j, t, _ids_by_tier(t, rng, 32 - cold_count,
                                          cold_count))


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("policy", [None, "int8"], ids=str)
def test_dedup_lookup_across_the_budget(placement, policy):
    """``dedup_cold``: unique cold counts 0, 3, 8, 9 and 30 over 24
    duplicated cold slots, duplicates past the budget whose uniques fit,
    and a hot-heavy batch whose unique count overflows while its cold
    slots fit the compaction budget."""
    feat = _table()
    j, t = _stores(feat, placement, device_cache_size=100 * 12,
                   cold_budget=8, dedup_cold=True, dtype_policy=policy)
    rng = np.random.default_rng(13)
    order = t.feature_order.numpy()
    hot = np.flatnonzero(order < t.cache_rows)
    cold = np.flatnonzero(order >= t.cache_rows)
    for uniq_cold in (0, 3, 8, 9, 30):
        pool = rng.choice(cold, max(uniq_cold, 1), replace=False)
        picks = pool[rng.integers(0, pool.size, 24)] if uniq_cold \
            else np.empty(0, np.int64)
        ids = np.concatenate([rng.choice(hot, 32 - picks.size), picks])
        rng.shuffle(ids)
        _check_lookups(j, t, ids)
    ids = np.concatenate([rng.choice(cold[:4], 28), rng.choice(hot, 4)])
    _check_lookups(j, t, ids)
    ids = np.concatenate([rng.choice(hot, 28, replace=False),
                          rng.choice(cold, 4)])
    _check_lookups(j, t, ids)


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("dedup", [False, True])
def test_lookup_without_a_device_cache(placement, dedup):
    feat = _table(n=150)
    j, t = _stores(feat, placement, topo=False, device_cache_size=0,
                   cold_budget=16, dedup_cold=dedup, dtype_policy="int8")
    assert t.device_part is None and j.device_part is None
    rng = np.random.default_rng(23)
    for pool_size in (10, 60):
        pool = rng.integers(0, 150, pool_size)
        _check_lookups(j, t, pool[rng.integers(0, pool_size, 80)])


@pytest.mark.parametrize("dedup", [False, True])
def test_masked_padding_with_node0_in_the_cold_tier(dedup):
    """Padding counts as hot even where the clip of -1 (node 0) lands in
    the cold tier: it takes no budget slot and gives a zero row."""
    feat = _table(n=120)
    order = np.arange(120, dtype=np.int32)
    order[0], order[100] = order[100], order[0]
    storage = np.empty_like(feat)
    storage[order] = feat
    j = qv.Feature(device_cache_size=60 * DIM * 4, cold_budget=4,
                   dedup_cold=dedup)
    j.from_cpu_tensor(feat)
    j.device_part = jnp.asarray(storage[:60])
    j.host_part = np.ascontiguousarray(storage[60:])
    j.feature_order = jnp.asarray(order)
    j._build_gather()
    t = Feature(device_cache_size=60 * DIM * 4, cold_budget=4,
                dedup_cold=dedup, host_placement="offload", device="cpu")
    t.from_cpu_tensor(storage)
    t.feature_order = torch.from_numpy(order)
    ids = np.full(64, -1, np.int64)
    ids[:3] = [5, 0, 119]
    want = _jax_lookup(j, ids, True)
    got = t.getitem_masked(ids)
    assert _same(got, want)
    expect = np.zeros((64, DIM), np.float32)
    expect[:3] = feat[[5, 0, 119]]
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("dedup", [False, True])
def test_randomized_lookups(dedup):
    feat = _table(n=300, seed=7)
    rng = np.random.default_rng(29)
    for budget in (4, 16, 64):
        j, t = _stores(feat, "offload", device_cache_size=150 * 12,
                       cold_budget=budget, dedup_cold=dedup,
                       dtype_policy="int8")
        for _ in range(2):
            pool = rng.integers(0, 300, int(rng.integers(8, 96)))
            _check_lookups(j, t, pool[rng.integers(0, pool.size, 96)])


def test_dedup_budget_from_an_int():
    """``dedup_cold=int`` sets the unique budget over ``cold_budget``."""
    feat = _table()
    j, t = _stores(feat, "offload", device_cache_size=100 * DIM * 4,
                   cold_budget=64, dedup_cold=6)
    rng = np.random.default_rng(5)
    for uniq in (4, 12):
        pool = rng.integers(0, N, uniq)
        _check_lookups(j, t, pool[rng.integers(0, uniq, 40)])


def test_jax_host_path_within_one_rounding():
    """JAX's numpy host path rounds an int8 decode once (through
    float64); the port's host path, like its kernels, rounds the
    multiply and the add: they differ by at most one rounding."""
    feat = _table()
    j, t = _stores(feat, "numpy", device_cache_size=100 * 12,
                   dtype_policy="int8")
    ids = np.random.default_rng(9).integers(0, N, 64)
    got = t[ids].numpy()
    np.testing.assert_allclose(got, np.asarray(j[jnp.asarray(ids)]),
                               rtol=0, atol=ONE_ROUNDING)
    assert _same(got, _jax_lookup(_exact_reference(j), ids))


# -- the host-read bound ------------------------------------------------------


@pytest.mark.parametrize("dedup", [False, True])
def test_host_reads_stay_within_the_budget(monkeypatch, dedup):
    """The host gather is handed at most ``budget`` non-negative ids on
    the narrow path, and no more than the batch's cold slots when the raw
    cold count overflows, below JAX's bound (``quant.dedup_rows_read``:
    ``budget`` more on unique overflow, the whole batch then)."""
    feat = _table()
    budget, n = 8, 64
    _, t = _stores(feat, "offload", device_cache_size=100 * DIM * 4,
                   cold_budget=budget, dedup_cold=dedup)
    host = t._host_offload
    reads = []
    real = tfeature.gather_rows

    def counting(table, ids, out=None):
        if table is host:
            reads.append(int((ids >= 0).sum()))
        return real(table, ids, out=out)

    monkeypatch.setattr(tfeature, "gather_rows", counting)
    rng = np.random.default_rng(4)
    order = t.feature_order.numpy()
    hot = np.flatnonzero(order < t.cache_rows)
    cold = np.flatnonzero(order >= t.cache_rows)
    cases = [  # (ids, most host rows the branch structure allows)
        (np.concatenate([rng.choice(hot, n - 5), rng.choice(cold, 5)]),
         budget),
        # hot-heavy: the unique count overflows, the cold slots fit
        (np.concatenate([rng.choice(hot, n - 4, replace=False),
                         rng.choice(cold, 4)]), budget),
        (np.concatenate([rng.choice(hot, n - 40),
                         rng.choice(cold, 40, replace=False)]), 40),
    ]
    for ids, bound in cases:
        rng.shuffle(ids)
        reads.clear()
        got = t[ids]
        assert np.array_equal(got.numpy(), feat[ids])
        assert reads and max(reads[:-1] or [0]) <= budget, reads
        assert sum(reads) <= bound, (reads, bound)
        n_cold = int((order[ids] >= t.cache_rows).sum())
        expect = quant.dedup_rows_read(order[ids], budget, n_cold) \
            if dedup else (budget if n_cold <= budget else budget + n)
        assert sum(reads) <= expect, (reads, expect)


# -- what is left for later ---------------------------------------------------


def test_deferred_pieces_raise():
    t = Feature(device_cache_size=50 * DIM * 4, device="cpu") \
        .from_cpu_tensor(_table())
    # the clique policies and share_ipc are ported (test_torch_clique.py,
    # test_torch_ipc.py): a clique of one device is replicated, and the
    # handle is JAX's tuple
    one = Feature(cache_policy="shard", device_cache_size=50 * DIM * 4,
                  device="cpu").from_cpu_tensor(_table())
    assert not one.sharded and torch.equal(one[[0, 5]], t[[0, 5]])
    handle = t.share_ipc()
    assert len(handle) == 6 and handle[:5] == (
        0, None, 50 * DIM * 4, "device_replicate", None)
    with pytest.raises(ValueError, match="cache_policy"):
        Feature(cache_policy="nope", device="cpu")
    with pytest.raises(ValueError, match="host_placement"):
        Feature(host_placement="disk", device="cpu")
    # the disk tier is ported (tests/test_torch_disk_tier.py): without one
    # attached, its reads and the cold prefetch refuse, and no prefetcher
    # is attached, as in the JAX package
    for call in (lambda: t.read_mmap([0]),
                 lambda: t.enable_cold_prefetch()):
        with pytest.raises(ValueError, match="set_mmap_file first"):
            call()
    assert t.stage_frontier([0]) is None
    assert torch.equal(t.prefetch([0, 1]).result(timeout=30), t[[0, 1]])
    t.close()
    # rotation, pickling and the counters are ported (test_torch_rotation.py,
    # test_torch_metrics.py): this store has no feature_order to rotate
    with pytest.raises(ValueError, match="feature_order"):
        t.rotate_hot_set([1], [2])
    import pickle
    assert torch.equal(pickle.loads(pickle.dumps(t))[[0, 1]], t[[0, 1]])
    rows, counters = t.lookup_tiered([0, 1], collect_metrics=True)
    assert torch.equal(rows, t[[0, 1]]) and counters.shape == (25,)
    t.close()
    t.close()
