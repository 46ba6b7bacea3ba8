"""The port's row gather (``quiver_tpu_torch/ops/kernels/gather.py``)
against the JAX package's Pallas kernel ``gather_rows``, run in
interpret mode as that package's tests run it, and over the packed int8
tier (``quant.pack``) against the JAX package's int8 tier lookup
(``quant.gather_rows``, run op by op: a rounded multiply, then a rounded
add). The port's wrapper gets CPU tensors, so it runs the kernel's plain
version; every output must match bit for bit."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import quant as jquant
from quiver_tpu.ops.pallas import gather as jgather
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import _build, gather

N = 300


def _ids(n=700):
    """700 ids (not a multiple of the Pallas kernel's 256-row block),
    with duplicates and both ends of the table."""
    ids = np.random.default_rng(3).integers(0, N, n).astype(np.int32)
    ids[:4] = [0, N - 1, 5, 5]
    return ids


def _jax_gather(feat, ids):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # JAX pads D to 128 lanes
        return jax.device_get(jgather.gather_rows(feat, jnp.asarray(ids),
                                                  interpret=True))


@pytest.mark.parametrize("dim", [12, 128])
def test_fp32_bit_exact(dim):
    feat = np.random.default_rng(dim).standard_normal((N, dim)) \
        .astype(np.float32)
    ids = _ids()
    want = np.asarray(_jax_gather(jnp.asarray(feat), ids))
    got = gather.gather_rows(torch.from_numpy(feat), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_bf16_bit_exact():
    feat = np.random.default_rng(4).standard_normal((N, 12)) \
        .astype(np.float32)
    ids = _ids()
    want = np.asarray(_jax_gather(jnp.asarray(feat, jnp.bfloat16), ids))
    tfeat = torch.from_numpy(feat).to(torch.bfloat16)
    got = gather.gather_rows(tfeat, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.view(torch.int16).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_other_dtypes_take_rows(dtype):
    g = np.random.default_rng(5)
    feat = torch.from_numpy(g.standard_normal((N, 7)).astype(np.float32)
                            * 20).to(dtype)
    ids = _ids(50)
    got = gather.gather_rows(feat, torch.from_numpy(ids))
    assert got.dtype == dtype
    assert torch.equal(got, feat[torch.from_numpy(ids).long()])


def test_int64_ids_are_cast():
    feat = torch.from_numpy(np.random.default_rng(6)
                            .standard_normal((N, 12)).astype(np.float32))
    ids = torch.from_numpy(_ids())
    assert torch.equal(gather.gather_rows(feat, ids.long()),
                       gather.gather_rows(feat, ids))


def test_no_ids_give_no_rows():
    feat = torch.zeros((N, 5))
    out = gather.gather_rows(feat, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 5) and out.dtype == torch.float32


def test_wrapper_refuses_what_the_kernel_does_not_take():
    feat = torch.zeros((N, 8))
    ids = torch.from_numpy(_ids(10))
    with pytest.raises(ValueError, match="fp32, bf16"):
        gather.gather_rows(feat.double(), ids)
    with pytest.raises(ValueError, match="contiguous 2-D"):
        gather.gather_rows(feat.t(), ids)
    with pytest.raises(ValueError, match="contiguous 2-D"):
        gather.gather_rows(feat[None], ids)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(feat, ids.float())
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(feat, ids.repeat(2)[::2])
    with pytest.raises(ValueError, match="on cpu"):      # devices differ
        gather.gather_rows(feat, ids.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather.gather_rows(feat.to("meta"), ids.to("meta"))


def test_cpu_tensors_take_the_plain_version():
    _build.reset_launches()
    gather.gather_rows(torch.zeros((N, 4)), torch.from_numpy(_ids(10)))
    assert _build.LAUNCHES["gather_rows"] == 0


# -- the packed int8 tier -----------------------------------------------------


def _packed(dim, seed=8):
    """The JAX package's int8 tier and the port's, packed, over one
    table."""
    f = np.random.default_rng(seed).standard_normal((N, dim)) \
        .astype(np.float32)
    return (jquant.quantize(jnp.asarray(f), "int8"),
            quant.pack(quant.quantize(torch.from_numpy(f), "int8")))


@pytest.mark.parametrize("dim", [7, 100, 128])
def test_packed_tier_equals_jax_tier_lookup(dim):
    """700 ids (not a multiple of a warp's 32), then ``out=`` with -1
    ids, which leave their rows as they were."""
    jq, tq = _packed(dim)
    assert tq.data.stride(0) == quant.packed_stride(dim)
    ids = _ids()
    want = np.asarray(jquant.gather_rows(jq, jnp.asarray(ids)))
    got = gather.gather_rows(tq, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    holes = ids.copy()
    holes[::3] = -1
    out = torch.full((ids.size, dim), 7.5)
    assert gather.gather_rows(tq, torch.from_numpy(holes), out=out) is out
    keep = (holes >= 0)[:, None]
    assert out.numpy().tobytes() == np.where(keep, want, 7.5) \
        .astype(np.float32).tobytes()


@pytest.mark.parametrize("dim,stride", [(7, None), (12, None), (100, None),
                                        (100, 112), (128, None)])
def test_pack_keeps_every_bit(dim, stride):
    """Pack, then read the leaves back: the same bits, -0.0, infinities
    and NaN payloads in the sidecars included; each row inside its
    stride, the sidecars in one 16-byte word, the padding zero."""
    g = np.random.default_rng(dim)
    codes = torch.from_numpy(g.integers(-128, 128, (N, dim), dtype=np.int8))
    words = g.integers(0, 2**32, (2, N, 1), dtype=np.uint32)
    words[:, :6, 0] = [0x80000000, 0x7FC01234, 0xFFC00001, 0x7F800000,
                       0xFF800000, 0x7F800001]
    scale, zero = (torch.from_numpy(w.view(np.float32)) for w in words)
    t = quant.pack(quant.QuantizedTensor(codes, scale, zero), stride)
    side = quant.sidecar_offset(dim)
    s = quant.packed_stride(dim) if stride is None else stride
    assert side >= dim and side % 4 == 0 and side // 16 == (side + 7) // 16
    assert s % 16 == 0 and s >= side + 8 and t.data.stride(0) == s
    if stride is None:                      # no row crosses a line it
        assert 128 % s == 0 if s <= 128 else s % 128 == 0   # need not
    for got, want in zip(t, (codes, scale, zero)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got.contiguous().view(torch.uint8),
                           want.view(torch.uint8))
    buf = torch.from_numpy(np.lib.stride_tricks.as_strided(
        t.data.view(torch.uint8).numpy(), (N, s), (s, 1)))
    assert not buf[:, dim:side].any() and not buf[:, side + 8:].any()


def _views(buf, dim, side, stride):
    rows = buf.view(-1, stride)
    return quant.QuantizedTensor(
        rows[:, :dim].view(torch.int8),
        rows[:, side:side + 4].view(torch.float32),
        rows[:, side + 4:side + 8].view(torch.float32))


@pytest.mark.parametrize("fault", ["misaligned", "mixed", "offset",
                                   "stride"])
def test_wrapper_refuses_a_bad_packed_tier(fault):
    dim, side, stride = 100, quant.sidecar_offset(100), 128
    buf = torch.zeros(N * stride + 16, dtype=torch.uint8)
    ids = torch.from_numpy(_ids(10))
    good = _views(buf[:N * stride], dim, side, stride)
    assert gather.gather_rows(good, ids).shape == (10, dim)
    if fault == "misaligned":
        bad = _views(buf[4:4 + N * stride], dim, side, stride)
    elif fault == "mixed":
        other = _views(torch.zeros(N * stride, dtype=torch.uint8), dim,
                       side, stride)
        bad = quant.QuantizedTensor(good.data, other.scale, good.zero)
    elif fault == "offset":
        bad = _views(buf[:N * stride], dim, side + 4, stride)
    else:
        bad = _views(buf[:N * 120], dim, side, 120)
    with pytest.raises(ValueError, match="packed rows"):
        gather.gather_rows(bad, ids)


# -- raw rows: the design each gather takes, and the plain versions at the
# row widths of the main paths ------------------------------------------------

# row bytes: the exchange's owner read (128), bf16 features (200), fp32
# features and the disk ring (400), the sampler's int32 rows views and the
# weight rows (512, 1,024), the hetero fp32 rows (3,072), and an odd width
RAW_ROW_BYTES = [128, 200, 400, 512, 1024, 3072, 7]


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
@pytest.mark.parametrize("on_host", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("align", [16, 8, 4, 2, 1])
@pytest.mark.parametrize("row_bytes", RAW_ROW_BYTES)
def test_raw_design_by_placement_width_and_alignment(row_bytes, align,
                                                     on_host, sharded):
    """Rows that may lie in pinned host memory take the loop design, in
    the widest of 16-, 4-, 2- and 1-byte words that divides the row and
    the alignment; rows on the card take the tile design, which also
    copies 8-byte words. The kernel names are the launch counters'."""
    design = gather.raw_design(on_host)
    assert design == ("loop" if on_host else "tile")
    word = gather.raw_word_bytes(design, row_bytes, align)
    words = (16, 4, 2, 1) if on_host else (16, 8, 4, 2, 1)
    assert word == max(w for w in words
                       if row_bytes % w == 0 and align % w == 0)
    kernel = gather.raw_kernel(design, sharded)
    assert kernel in _build.RAW_LAUNCHES
    assert ("sharded" in kernel) == sharded
    assert ("tile" in kernel) == (design == "tile")


def test_raw_words_and_alignment():
    assert gather.address_align(0x1000, 0x2010) == 16
    assert gather.address_align(0x1008, 0x2000) == 8
    assert gather.address_align(0x1000, 0x2006) == 2
    assert gather.address_align(0x1001) == 1
    assert gather.address_align() == 16
    # the loop design has no 8-byte words
    assert gather.raw_word_bytes("loop", 200, 16) == 4
    assert gather.raw_word_bytes("tile", 200, 16) == 8
    assert gather.raw_word_bytes("tile", 200, 4) == 4
    assert [gather.raw_kernel(d) for d in gather.RAW_DESIGNS] == [
        "gather_rows_kernel", "gather_rows_tile_kernel"]
    assert [gather.raw_kernel(d, True) for d in gather.RAW_DESIGNS] == [
        "gather_rows_sharded_kernel", "gather_rows_sharded_tile_kernel"]


# (dtype, width) giving each row width of RAW_ROW_BYTES
RAW_TABLES = [(np.float32, 32), ("bfloat16", 100), (np.float32, 100),
              (np.int32, 128), (np.float32, 256), (np.float32, 768),
              (np.int8, 7)]


def _raw_table(dtype, dim):
    """The same table for JAX and the port: its numpy values, JAX's
    array and the port's tensor."""
    g = np.random.default_rng(dim)
    vals = g.standard_normal((N, dim)).astype(np.float32) * 20
    if dtype == "bfloat16":
        j = jnp.asarray(vals, jnp.bfloat16)
        t = torch.from_numpy(vals).to(torch.bfloat16)
        assert np.asarray(j).view(np.int16).tobytes() \
            == t.view(torch.int16).numpy().tobytes()
        return j, t
    vals = vals.astype(dtype)
    return jnp.asarray(vals), torch.from_numpy(vals)


def _raw_bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("dtype,dim", RAW_TABLES,
                         ids=[f"{b}B" for b in RAW_ROW_BYTES])
def test_raw_plain_versions_equal_jax_gather(dtype, dim):
    """``gather_rows_plain`` and ``gather_rows_sharded_plain`` (three
    blocks, one of them empty) against JAX's Pallas ``gather_rows`` in
    interpret mode, bit for bit, at each row width: the lookup form, then
    ``out=`` with -1 ids, which leave their rows as they were."""
    jt, tt = _raw_table(dtype, dim)
    ids = _ids(300)
    want = _raw_bits(_jax_gather(jt, ids))
    tids = torch.from_numpy(ids)
    tier = quant.ShardedTier([tt[:100], tt[100:100], tt[100:]],
                             [0, 100, 100, N], torch.device("cpu"))
    holes = ids.copy()
    holes[::4] = -1
    keep = (holes >= 0)[:, None]
    for plain, table in ((gather.gather_rows_plain, tt),
                         (gather.gather_rows_sharded_plain, tier)):
        got = plain(table, tids)
        assert got.dtype == tt.dtype and tuple(got.shape) == want.shape
        assert _raw_bits(got.view(torch.int16) if got.element_size() == 2
                         else got).tobytes() == want.tobytes()
        base = torch.full((ids.size, dim), 7).to(tt.dtype)
        out = plain(table, torch.from_numpy(holes), out=base.clone())
        out = _raw_bits(out.view(torch.int16) if out.element_size() == 2
                        else out)
        fill = _raw_bits(base.view(torch.int16) if base.element_size() == 2
                         else base)
        assert np.where(keep, want, fill).tobytes() == out.tobytes()
