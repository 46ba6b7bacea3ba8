"""The span gather (``ops/kernels/gather.py: gather_segments``) and its
callers, ``ops/sample.py: take_segments`` in ``_segment_heads`` and in the
weighted pool draw (``ops/weighted.py: _pool_draw``), on the CPU.

``gather_segments_plain`` reads each seed's ``count`` consecutive
elements from ``start`` and gives -1 past them: it must equal
``gather_elems_plain`` over the implied ids ``where(j < count, start +
j, -1)`` exactly, for int32, int64 and fp32 tables (fp32 read as its
int32 words), at widths 1, 2, 7 and 64, counts from 0 to the width,
starts at the table's end and spans that run past it (clamped, as the
flat form clamps).

The heads and the pool draw are held to the JAX package on numpy inputs
made from a seed: ``_segment_heads`` exactly against JAX's
(``quiver_tpu/ops/sample.py: _segment_heads``), and the pool draw's
picks, counts and slots exactly against JAX's ``sample_layer_weighted``
on JAX's uniforms (integer weights, so both fp32 cumsums are exact), in
both routes of ``take_segments``: plain indexing (HBM mode, the CPU) and
the span gather's form, which gives -1 past a seed's count (HOST mode's
kernel; on CPU tensors its plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import sample as jsample
from quiver_tpu.ops import weighted as jweighted
from quiver_tpu_torch.ops import sample, weighted
from quiver_tpu_torch.ops.kernels import _build, gather

KEY = jax.random.key(5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spans(g, n_table, bs, width):
    """Starts and counts of every kind the kernel must get right: counts
    0..width (and past it), starts at 0, inside, at the table's end and
    running past it."""
    start = g.integers(0, n_table, bs).astype(np.int64)
    count = g.integers(0, width + 1, bs).astype(np.int32)
    start[:4] = [0, n_table - 1, n_table, n_table - 1]
    count[:4] = [width, width, 0, width]
    count[4] = width + 3                 # more than the width: cut to it
    count[5] = 0
    return _t(start), _t(count)


def _table(g, dtype, n):
    if dtype == torch.float32:
        return torch.from_numpy(g.standard_normal(n).astype(np.float32))
    return torch.from_numpy(g.integers(-2**31, 2**31 - 1, n)).to(dtype)


@pytest.mark.parametrize("width", [1, 2, 7, 64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_plain_equals_flat_over_implied_ids(dtype, width):
    g = np.random.default_rng(width)
    table = _table(g, dtype, 300)
    start, count = _spans(g, 300, 50, width)
    got = gather.gather_segments_plain(table, start, count, width)
    j = torch.arange(width)
    ids = torch.where(j < count[:, None], start[:, None] + j, -1)
    words = table.view(torch.int32) if dtype == torch.float32 else table
    want = gather.gather_elems_plain(words, ids.reshape(-1)) \
        .reshape(50, width)
    assert got.dtype == dtype and tuple(got.shape) == (50, width)
    got_w = got.view(torch.int32) if dtype == torch.float32 else got
    assert torch.equal(got_w, want)
    # -1 (its bits for fp32) exactly where no element is read
    assert bool((got_w[ids < 0] == -1).all())
    live = ids >= 0
    assert torch.equal(got_w[live], words[ids[live].clamp(max=299)])


@pytest.mark.parametrize("width", [1, 2, 7, 64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_wrapper_on_cpu_takes_the_plain_version(dtype, width):
    g = np.random.default_rng(100 + width)
    table = _table(g, dtype, 300)
    start, count = _spans(g, 300, 40, width)
    _build.reset_launches()
    want = gather.gather_segments_plain(table, start, count, width)
    got = gather.gather_segments(table, start, count, width)
    out = torch.full((40, width), 3, dtype=dtype)
    filled = gather.gather_segments(table, start, count, width, out=out)
    for x in (got, filled):
        assert torch.equal(x.view(torch.uint8), want.view(torch.uint8))
    assert filled.data_ptr() == out.data_ptr()
    assert _build.LAUNCHES["gather_elems"] == 0
    assert not any(_build.ELEMS_LAUNCHES.values())


def test_no_spans_give_an_empty_result():
    table = torch.arange(10, dtype=torch.int32)
    got = gather.gather_segments(table, torch.zeros(0, dtype=torch.int64),
                                 torch.zeros(0, dtype=torch.int32), 5)
    assert tuple(got.shape) == (0, 5) and got.dtype == torch.int32


@pytest.mark.parametrize("fault", ["table dtype", "table 2-D", "start int32",
                                   "count int64", "lengths", "width",
                                   "out dtype", "out shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    table = torch.arange(10, dtype=torch.int32)
    start = torch.zeros(4, dtype=torch.int64)
    count = torch.ones(4, dtype=torch.int32)
    width, out = 3, None
    if fault == "table dtype":
        table = table.to(torch.int16)
    elif fault == "table 2-D":
        table = table.reshape(2, 5)
    elif fault == "start int32":
        start = start.int()
    elif fault == "count int64":
        count = count.long()
    elif fault == "lengths":
        count = count[:3]
    elif fault == "width":
        width = -1
    elif fault == "out dtype":
        out = torch.zeros((4, 3), dtype=torch.int64)
    else:
        out = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.gather_segments(table, start, count, width, out=out)


def test_take_segments_refuses_other_pairings():
    table = torch.arange(10, dtype=torch.int32)
    start = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cannot read"):
        sample.take_segments(table, start, torch.ones(3, dtype=torch.int32,
                                                      device="meta"), 2)


def _kernel_route(monkeypatch):
    """``take_segments`` forced through the span gather's wrapper, as in
    HOST mode: on CPU tensors it runs ``gather_segments_plain``, -1 past
    each seed's count where plain indexing reads slot 0."""
    calls = []

    def forced(table, start, count, width):
        calls.append(width)
        return gather.gather_segments(table, start.long().contiguous(),
                                      count.to(torch.int32).contiguous(),
                                      width)
    monkeypatch.setattr(sample, "take_segments", forced)
    monkeypatch.setattr(weighted, "take_segments", forced)
    return calls


@pytest.fixture(scope="module")
def graph():
    """Isolated rows, hubs past ``row_cap`` 16, a zero-mass row, integer
    weights with zeros and negatives, -1 seeds and the last node."""
    g = np.random.default_rng(7)
    n = 150
    deg = g.integers(0, 25, n)
    deg[[0, 3, n - 1]] = 0
    deg[[4, 5]] = 200
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = g.integers(0, n, e).astype(np.int32)
    w = g.integers(-2, 5, e).astype(np.float32)
    w[indptr[8]:indptr[9]] = 0.0
    seeds = np.concatenate([np.arange(30), [-1, 4, 5, 8, n - 1, -1,
                                            n - 2]]).astype(np.int32)
    return indptr, indices, w, seeds


@pytest.mark.parametrize("route", ["indexing", "span kernel form"])
@pytest.mark.parametrize("ip_dtype", [np.int32, np.int64])
def test_segment_heads_equal_jax(graph, ip_dtype, route, monkeypatch):
    indptr, _, _, seeds = graph
    indptr = indptr.astype(ip_dtype)
    calls = _kernel_route(monkeypatch) if route != "indexing" else None
    start, deg = sample._segment_heads(_t(indptr), _t(seeds))
    j_start, j_deg = jsample._segment_heads(jnp.asarray(indptr),
                                            jnp.asarray(seeds))
    valid = seeds >= 0
    np.testing.assert_array_equal(deg.numpy(), np.asarray(j_deg))
    np.testing.assert_array_equal(start.numpy()[valid],
                                  np.asarray(j_start)[valid])
    assert (start.numpy()[~valid] == 0).all()
    assert calls is None or calls == [2]


@pytest.mark.parametrize("route", ["indexing", "span kernel form"])
@pytest.mark.parametrize("row_cap", [16, 2048])
def test_pool_draw_through_take_segments_equals_jax(graph, row_cap, route,
                                                    monkeypatch):
    indptr, indices, w, seeds = graph
    k = 4
    calls = _kernel_route(monkeypatch) if route != "indexing" else None
    u = np.asarray(jax.random.uniform(KEY, (seeds.shape[0], k),
                                      dtype=jnp.float32))
    want = jweighted.sample_layer_weighted(
        jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(w),
        jnp.asarray(seeds), k, KEY, row_cap=row_cap, with_slots=True)
    got = weighted._pool_draw(_t(indptr), _t(indices), _t(w), _t(seeds), k,
                              _t(u), row_cap, True)
    for a, b, name in zip(got, want, ("nbrs", "counts", "slots")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert calls is None or calls == [2, row_cap]
