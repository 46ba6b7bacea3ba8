"""The port's frontier dedup (``quiver_tpu_torch/ops/dedup.py``), the
dedup gather of the split route (``parallel/train.py:
dedup_feature_gather``) and the store's sizing helpers
(``ops/quant.py``) against the JAX package's, on the CPU.

``unique_within_budget`` must return JAX's ``uniq`` (int32-max fill
included), ``inv`` and ``n_uniq`` exactly, with and without ``valid``,
under and over the budget. The gathers are compared bit for bit at
every position the JAX function defines. An int8 table's rows are
decoded by the port with a rounded multiply and a rounded add (as the
kernels do), which XLA on the CPU contracts into one fused multiply-add;
so over an int8 table the JAX function runs on the table decoded by
numpy with two roundings for the bit-for-bit check, and on the int8
table itself within one rounding (``ONE_ROUNDING``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import dedup as jdedup
from quiver_tpu.ops import quant as jquant
from quiver_tpu.parallel import train as jtrain
from quiver_tpu_torch.ops import dedup, quant
from quiver_tpu_torch.parallel import (dedup_feature_gather,
                                       masked_feature_gather)

N, DIM = 120, 6
# half an ulp of a product below 8 in magnitude is 2**-22; room for one
ONE_ROUNDING = 2.0 ** -20


def _ids(seed, n=64, pool=20, pad=0):
    g = np.random.default_rng(seed)
    ids = g.choice(N, pool, replace=False)[g.integers(0, pool, n)]
    ids[g.choice(n, pad, replace=False)] = -1
    return ids.astype(np.int32)


def _table():
    return np.random.default_rng(9).standard_normal((N, DIM)) \
        .astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _tables(kind):
    """``(port table, JAX table, JAX table the port equals bit for
    bit)`` for an fp32 or an int8 table."""
    feat = _table()
    if kind == "fp32":
        return torch.from_numpy(feat), jnp.asarray(feat), jnp.asarray(feat)
    q = jquant.quantize(feat, "int8")
    two = q.data.astype(np.float32) * q.scale + q.zero
    return (quant.QuantizedTensor(*(torch.from_numpy(a) for a in q)),
            jquant.tree_map_tier(jnp.asarray, q), jnp.asarray(two))


def _check(got, jax_fn, jtable, jexact, keep=None):
    want = np.asarray(jax_fn(jexact))
    keep = np.ones(want.shape[0], bool) if keep is None else keep
    assert got.shape == want.shape
    assert np.array_equal(_bits(got.numpy()[keep]), _bits(want[keep]))
    np.testing.assert_allclose(got.numpy()[keep],
                               np.asarray(jax_fn(jtable))[keep], rtol=0,
                               atol=ONE_ROUNDING)


# (pool of distinct ids, budget, padded slots)
CASES = [(20, 32, 0), (20, 20, 0), (20, 19, 0), (40, 8, 0), (20, 32, 9),
         (20, 16, 30), (1, 4, 0), (30, 200, 5)]


@pytest.mark.parametrize("pool,budget,pad", CASES)
@pytest.mark.parametrize("with_valid", [False, True])
def test_unique_within_budget_equals_jax(pool, budget, pad, with_valid):
    ids = _ids(pool * 7 + budget, pool=pool, pad=pad)
    valid = ids >= 0 if with_valid else None
    want = jax.device_get(jdedup.unique_within_budget(
        jnp.asarray(ids), budget,
        valid=None if valid is None else jnp.asarray(valid)))
    got = dedup.unique_within_budget(
        torch.from_numpy(ids), budget,
        valid=None if valid is None else torch.from_numpy(valid))
    for g, w, name in zip(got, want, ("uniq", "inv", "n_uniq")):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("budget", [8, 20, 64, 100])
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_dedup_take_equals_jax(budget, kind):
    table, jtable, jexact = _tables(kind)
    ids = _ids(budget, n=80, pool=15)
    ids[3] = N + 5                        # clipped into the table
    for valid in (None, ids % 3 != 0):
        jvalid = None if valid is None else jnp.asarray(valid)
        got = dedup.dedup_take(
            table, torch.from_numpy(ids), budget,
            valid=None if valid is None else torch.from_numpy(valid))
        _check(got, lambda t: jdedup.dedup_take(t, jnp.asarray(ids), budget,
                                                valid=jvalid),
               jtable, jexact, valid)


@pytest.mark.parametrize("budget", [None, 12, 40, 200])
@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("with_order", [False, True])
def test_dedup_feature_gather_equals_masked_and_jax(budget, kind,
                                                    with_order):
    table, jtable, jexact = _tables(kind)
    order = np.random.default_rng(2).permutation(N).astype(np.int32) \
        if with_order else None
    torder = None if order is None else torch.from_numpy(order)
    jorder = None if order is None else jnp.asarray(order)
    ids = _ids(7, n=300, pool=30, pad=40)
    got = dedup_feature_gather(table, torch.from_numpy(ids), torder, budget)
    plain = masked_feature_gather(table, torch.from_numpy(ids), torder)
    valid = ids >= 0
    assert torch.equal(got[valid], plain[valid])
    assert not got[~valid].any()
    _check(got, lambda t: jtrain.dedup_feature_gather(
        t, jnp.asarray(ids), jorder, budget), jtable, jexact)


def test_budget_helpers_equal_jax():
    for n in (0, 10, 1023, 1024, 1025, 180_224):
        assert quant.default_cold_budget(n) == jquant.default_cold_budget(n)
    for policy in (None, "fp32", "bf16", "fp16", "int8"):
        assert quant.storage_itemsize(policy) == \
            jquant.storage_itemsize(policy)
        for dim in (1, 100, 128):
            assert quant.row_bytes(dim, policy) == \
                jquant.row_bytes(dim, policy)
    g = np.random.default_rng(1)
    for pool, n in ((5, 40), (40, 40), (300, 400), (900, 1000)):
        ids = g.integers(-1, pool, n)
        for budget in (None, 8, 64, 2000):
            for cold in (None, 0, 7, 64, n):
                assert quant.dedup_rows_read(torch.from_numpy(ids), budget,
                                             cold) == \
                    jquant.dedup_rows_read(ids, budget, cold)


@pytest.mark.parametrize("policy", [None, "bf16", "int8"])
def test_plan_hot_capacity_equals_jax(policy):
    deg = np.random.default_rng(4).integers(0, 50, 1000)
    for budget in (0, 4096, 64 * 1024, 10**9):
        for degree in (None, deg):
            want = jquant.plan_hot_capacity(budget, 1000, 100, policy, 4,
                                            degree)
            got = quant.plan_hot_capacity(
                budget, 1000, 100, policy, 4,
                None if degree is None else torch.from_numpy(degree))
            assert tuple(got) == tuple(want)


def test_take_np_within_one_rounding_of_jax():
    """JAX's ``take_np`` decodes through float64 and rounds once; the
    port's rounds the multiply and the add, as its kernels do."""
    feat = _table()
    q = jquant.quantize(feat, "int8")
    ids = np.array([0, 5, N - 1, 5, 77])
    want = jquant.take_np(q, ids)
    got = quant.take_np(quant.QuantizedTensor(*(torch.from_numpy(a)
                                                for a in q)), ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -20)
    two = q.data[ids].astype(np.float32) * q.scale[ids] + q.zero[ids]
    assert np.array_equal(_bits(got.numpy()), _bits(two))
    plain = quant.take_np(feat, ids)
    assert np.array_equal(plain.numpy(), jquant.take_np(feat, ids))


def test_unique_np_equals_jax():
    ids = _ids(3, pad=10)
    valid = np.arange(ids.size) % 4 != 0
    for v in (None, valid):
        want = jdedup.unique_np(ids, v)
        assert np.array_equal(dedup.unique_np(torch.from_numpy(ids),
                                              None if v is None else
                                              torch.from_numpy(v)), want)
        assert np.array_equal(dedup.unique_np(ids, v), want)
