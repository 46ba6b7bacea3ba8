"""Row gather (counterpart of ``quiver_tpu/ops/pallas/gather.py``).

:func:`gather_rows` computes ``out[i] = feat[ids[i]]`` for a 2-D
contiguous fp32, bf16, fp16, int8 or int32 table (int32: the sampler's
rows views of a topology), or for an int8
``QuantizedTensor`` with fp32 sidecars, whose rows it dequantizes to
fp32 as it reads them: its leaves contiguous (a device table), or
views into one buffer of packed rows (``quant.pack``: the cold tier as
``utils/placement.py`` pins it, each row one aligned host read). On
CUDA ids it launches a kernel of ``csrc/gather.cu``; the table lies on
the ids' card or in pinned host memory, which the kernel reads over
PCIe, as the reference's UVA gather does: the cold tier of the feature
store. On CPU ids it runs the plain version :func:`gather_rows_plain`.
Unlike the JAX function, neither the width nor the id count is
padded. Packed int8 rows are read by one of two kernels, picked by where
the rows lie (:func:`packed_kernel`): pinned host rows by the host
design, which keeps many read requests in flight over PCIe, rows in
device memory by the HBM design, which writes the decoded rows in
coalesced runs. Raw rows (any other table) are read by one of the
designs of :data:`RAW_DESIGNS`, which :func:`raw_launch` picks (the
design by where the rows lie, :func:`raw_design`; the words by the
rows' bytes and the addresses' alignment) and tells the C entry: rows
on the card by the tile design (a block's tile of consecutive output
rows, the lanes of a row as many as its words), pinned host rows by the
loop design (one row a warp). Launches are counted by kernel in
``RAW_LAUNCHES``.

With ``out=``, the rows are written into ``out`` and a negative id
leaves its row of ``out`` as it is, reading nothing: the tiered lookup
gives each branch's reads -1 where the branch does not read, so the
host decides nothing. Without ``out=`` every id must lie in the table
(the kernel clamps one that does not).

:func:`gather_elems` is the same gather over a 1-D int32, int64 or fp32
table (``indptr``, ``indices``, an edge-id map, edge weights): the
sampler's HOST mode reads its pinned topology and weights through it,
one id a thread, a negative id giving the bits of int -1 and reading
nothing. :func:`gather_elems_plain` is its plain version.

:func:`gather_rows_sharded` is the same row gather over a
``quant.ShardedTier``: one table cut into row blocks on several cards
(peers of the lookups' card) or in pinned host memory. One launch finds
each id's block from the offsets and copies (or decodes) its row from
that block's address: the clique store's hot tier and a
``ShardTensor``'s groups. :func:`gather_rows_sharded_plain` is its plain
version. :func:`enable_peer_access` lets one card read another's memory
(``cudaDeviceEnablePeerAccess``, which PyTorch does not expose).
"""

from __future__ import annotations

import ctypes

import torch

from .. import quant
from . import _build
from .sample_kernel import _check_1d_int32

_LIB = "gather"
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
           torch.int32)
_ELEM_DTYPES = (torch.int32, torch.int64)


def _lib():
    lib = _build.load(_LIB)
    if not getattr(lib, "_qt_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qt_gather_rows.argtypes = [p, i, p, ll, ll, ll, p, i, i, i, p]
        lib.qt_gather_rows.restype = i
        lib.qt_gather_rows_q8.argtypes = [p, p, p, i, p, ll, ll, ll, p, i, p]
        lib.qt_gather_rows_q8.restype = i
        lib.qt_gather_rows_packed.argtypes = [p, i, p, ll, ll, ll, ll, ll,
                                              p, i, p]
        lib.qt_gather_rows_packed.restype = i
        lib.qt_gather_q8_vec.argtypes = [p, p, ll]
        lib.qt_gather_q8_vec.restype = i
        lib.qt_gather_elems.argtypes = [p, i, i, p, i, ll, ll, p, p]
        lib.qt_gather_elems.restype = i
        lib.qt_gather_segments.argtypes = [p, i, i, p, p, ll, ll, ll, p, p]
        lib.qt_gather_segments.restype = i
        lib.qt_gather_rows_sharded.argtypes = [p, p, i, ll, i, p, ll, ll,
                                               ll, ll, ll, p, i, i, i, p]
        lib.qt_gather_rows_sharded.restype = i
        lib.qt_device_address.argtypes = [p, i, ctypes.POINTER(p)]
        lib.qt_device_address.restype = i
        lib.qt_enable_peer_access.argtypes = [i, i]
        lib.qt_enable_peer_access.restype = i
        lib._qt_bound = True
    return lib


def _leaves(feat):
    """The table's storage leaves, checked: ``(data, scale, zero,
    stride)``, ``stride`` the row stride in bytes of a packed int8 tier
    and None where the leaves are contiguous."""
    data, scale, zero = quant.tier_parts(feat)
    if not torch.is_tensor(data) or data.dim() != 2 \
            or data.dtype not in _DTYPES \
            or (scale is None and not data.is_contiguous()):
        raise ValueError(
            "gather_rows takes a contiguous 2-D fp32, bf16, fp16, int8 or "
            f"int32 table, got {getattr(data, 'dtype', type(data))} "
            f"{tuple(getattr(data, 'shape', ()))}")
    if scale is None:
        return data, None, None, None
    for side in (scale, zero):
        if data.dtype != torch.int8 or not torch.is_tensor(side) \
                or not side.is_floating_point() \
                or tuple(side.shape) != (data.shape[0], 1) \
                or side.device != data.device:
            raise ValueError(
                "a quantized table is int8 [N, D] codes with float "
                "[N, 1] scale and zero beside them")
    if data.is_contiguous() and scale.is_contiguous() \
            and zero.is_contiguous():
        return data, scale, zero, None
    stride, base = data.stride(0), data.data_ptr()
    side = quant.sidecar_offset(data.shape[1])
    buf = data.untyped_storage().data_ptr()
    if data.stride(1) != 1 or stride % 16 or stride < side + 8 \
            or base % 16 \
            or scale.dtype != torch.float32 or zero.dtype != torch.float32 \
            or any(t.untyped_storage().data_ptr() != buf
                   or t.stride(0) * 4 != stride for t in (scale, zero)) \
            or scale.data_ptr() != base + side \
            or zero.data_ptr() != base + side + 4:
        raise ValueError(
            "a quantized table's leaves are contiguous, or views into one "
            "buffer of packed rows (quant.pack): 16-byte aligned, a row "
            "stride that is a multiple of 16, fp32 scale and zero at "
            "bytes quant.sidecar_offset(D) and 4 past it")
    return data, scale, zero, stride


def packed_row_stride(feat):
    """The row stride in bytes of an int8 table in packed rows
    (``quant.pack``), None for any other table; raises on a layout that
    ``gather_rows`` does not take."""
    return _leaves(feat)[3]


def _check_out(out, n, dim, dtype, dev):
    if not torch.is_tensor(out) or out.dtype != dtype \
            or tuple(out.shape) != (n, dim) or not out.is_contiguous() \
            or out.device != dev:
        raise ValueError(
            f"out must be a contiguous {dtype} [{n}, {dim}] tensor on {dev}")


def gather_rows_plain(feat, ids, out=None):
    """Plain version of :func:`gather_rows`: index on the table's side
    (host or device), copy the rows to the ids' device, and write into
    ``out`` only where the id is not negative. Ids are clamped into the
    table, as the kernel clamps them."""
    data, _, _ = quant.tier_parts(feat)
    idx = ids.to(data.device).long().clamp(0, max(data.shape[0] - 1, 0))
    rows = quant.gather_rows(feat, idx).to(ids.device)
    if out is None:
        return rows
    keep = (ids >= 0)[:, None]
    return out.copy_(torch.where(keep, rows, out))


# -- raw rows: the two designs of csrc/gather.cu -----------------------------

# each design's number in the C entries, and the words (bytes) it copies in
RAW_DESIGNS = {"loop": 0, "tile": 1}
_RAW_WORDS = {"loop": (16, 4, 2, 1), "tile": (16, 8, 4, 2, 1)}


def address_align(*addrs) -> int:
    """The largest of 16, 8, 4, 2 and 1 that divides every address (and
    row stride) given."""
    bits = 16
    for a in addrs:
        bits |= int(a)
    return bits & -bits


def raw_design(on_host: bool) -> str:
    """The design a gather of raw (not packed) rows takes. Rows that may
    lie in pinned host memory (``on_host``: the table, or a block of a
    sharded one) take the loop design, one row a warp: the host's rate
    of read requests bounds them, and a row read by one instruction
    touches the fewest 128-byte lines. Rows on the card take the tile
    design (a block's tile of consecutive output rows, the lanes of a
    row as many as its words). The rows' bytes and the addresses'
    alignment then pick the words (:func:`raw_word_bytes`); flat and
    sharded tables take the same rule."""
    return "loop" if on_host else "tile"


def raw_kernel(design: str, sharded: bool = False) -> str:
    """The kernel of a raw-row design: its profiler name and its key in
    ``RAW_LAUNCHES``."""
    name = "gather_rows_sharded" if sharded else "gather_rows"
    return f"{name}_kernel" if design == "loop" else f"{name}_{design}_kernel"


def raw_word_bytes(design: str, row_bytes: int, align: int) -> int:
    """The words a design copies a row in: the widest it takes that
    divides the row and ``align``."""
    for w in _RAW_WORDS[design]:
        if row_bytes % w == 0 and align % w == 0:
            return w
    raise ValueError(f"the {design} design takes no word for {row_bytes}-"
                     f"byte rows at {align}-byte alignment")


def raw_launch(table, out):
    """``(design, word bytes, kernel)`` of a gather of raw rows of
    ``table`` (a 2-D tensor on a card or pinned, or a ``quant.ShardedTier``
    of raw rows) into ``out`` on a card, as :func:`raw_design` picks
    them."""
    if quant.is_sharded(table):
        _, _, bits, _, on_host = _sharded_table(table)
        row = table.dim * quant.tier_parts(table.shards[0])[0].element_size()
        sharded = True
    else:
        bits, on_host = table.data_ptr(), table.device.type == "cpu"
        row = table.shape[1] * table.element_size()
        sharded = False
    align = address_align(bits, out.data_ptr())
    design = raw_design(on_host)
    return design, raw_word_bytes(design, row, align), raw_kernel(design,
                                                                  sharded)


def word_bytes(feat, out) -> int:
    """The width of the words the kernel copies for ``feat`` into
    ``out``: for raw rows, the design's (:func:`raw_launch`) 16, 8, 4, 2
    or 1 bytes; for a quantized table, 4 or 1 int8 codes (a packed tier is
    read in 16-byte words)."""
    data, scale, _, stride = _leaves(feat)
    if stride is not None:
        return 16
    if scale is not None:
        return _lib().qt_gather_q8_vec(data.data_ptr(), out.data_ptr(),
                                       data.shape[1])
    return raw_launch(data, out)[1]


def packed_kernel(on_host: bool, sharded: bool = False) -> str:
    """The kernel a packed int8 gather launches: the host design where a
    row may lie in pinned host memory, else the HBM design (its profiler
    name and its key in ``PACKED_LAUNCHES``)."""
    name = "gather_rows_sharded_packed" if sharded else "gather_rows_packed"
    return f"{name}_kernel" if on_host else f"{name}_hbm_kernel"


@_build.recorded("gather_rows")
def gather_rows(feat, ids, out=None):
    """``out[i] = feat[ids[i]]``. ``feat`` is a contiguous ``[N, D]``
    fp32, bf16, fp16 or int8 tensor, or an int8 ``QuantizedTensor``
    with contiguous leaves or packed by ``quant.pack`` (rows come back
    dequantized in its sidecars' dtype; the kernel takes fp32
    sidecars). ``ids`` is a contiguous 1-D int32 tensor (int64 ids
    are cast); rows come back on its device. On a card, the table lies
    on that card or in pinned host memory. Without ``out`` every id must
    lie in ``[0, N)`` (the kernel clamps one outside it into the table
    and reads nothing outside); with ``out`` (contiguous ``[n, D]`` of
    the rows' dtype on the ids' device) a negative id leaves its row of
    ``out`` untouched and reads nothing, and ``out`` is returned. A
    ``quant.ShardedTier`` goes to :func:`gather_rows_sharded`."""
    if quant.is_sharded(feat):
        return gather_rows_sharded(feat, ids, out)
    data, scale, zero, stride = _leaves(feat)
    if torch.is_tensor(ids) and ids.dtype == torch.int64:
        ids = ids.to(torch.int32)
    home = data.device
    dev = ids.device if torch.is_tensor(ids) else home
    on_host = dev.type == "cuda" and home.type == "cpu"
    if on_host and not data.is_pinned():
        raise ValueError("gather_rows reads a host table from the card "
                         "only when it lies in pinned memory")
    _check_1d_int32(ids, "ids", dev if on_host else home)
    n, dim = ids.shape[0], data.shape[1]
    dtype = quant.tier_dtype(feat)
    if out is not None:
        _check_out(out, n, dim, dtype, dev)
    if dev.type == "cpu":
        return gather_rows_plain(feat, ids, out)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {dev}")
    if scale is not None and (scale.dtype != torch.float32
                              or zero.dtype != torch.float32):
        raise ValueError("the int8 gather kernel takes fp32 scale and zero")
    skip = int(out is not None)
    if out is None:
        out = torch.empty((n, dim), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    if data.shape[0] < 1:
        raise ValueError("gather_rows: ids index an empty table")
    kernel = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stride is not None:
            kernel = packed_kernel(on_host)
            err = _lib().qt_gather_rows_packed(
                data.data_ptr(), int(on_host), ids.data_ptr(), n,
                data.shape[0], stride, dim, quant.sidecar_offset(dim),
                out.data_ptr(), skip, stream)
        elif scale is None:
            design, word, kernel = raw_launch(data, out)
            err = _lib().qt_gather_rows(
                data.data_ptr(), int(on_host), ids.data_ptr(), n,
                data.shape[0], dim * data.element_size(), out.data_ptr(),
                skip, RAW_DESIGNS[design], word, stream)
        else:
            kernel = "gather_rows_q8_kernel"
            err = _lib().qt_gather_rows_q8(
                data.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                int(on_host), ids.data_ptr(), n, data.shape[0], dim,
                out.data_ptr(), skip, stream)
    _build.launched(err, "gather_rows", kernel)
    return out


def gather_elems_plain(table, ids):
    """Plain version of :func:`gather_elems`: index on the table's side
    (host or device) with the ids clamped into it, copy to the ids'
    device, -1 where the id is negative."""
    idx = ids.to(table.device).long().clamp(0, max(table.shape[0] - 1, 0))
    vals = table[idx].to(ids.device)
    return torch.where(ids >= 0, vals, -1)


@_build.recorded("gather_elems")
def gather_elems(table, ids):
    """``out[i] = table[ids[i]]`` for a contiguous 1-D int32, int64 or
    fp32 ``table``; ``ids`` a contiguous 1-D int32 or int64 tensor. A
    negative id gives -1 (for fp32 its bits, a NaN) and reads nothing; an
    id past the table is clamped into it. The result has the table's
    dtype and lies on the ids' device. On a card the table lies on that
    card or in pinned host memory, which the kernel reads over PCIe; on
    CPU ids the plain version runs. An fp32 table is read as the int32
    words it is made of, by the same kernel."""
    if torch.is_tensor(table) and table.dtype == torch.float32:
        return gather_elems(table.view(torch.int32), ids) \
            .view(torch.float32)
    for t, name in ((table, "table"), (ids, "ids")):
        if not torch.is_tensor(t) or t.dtype not in _ELEM_DTYPES \
                or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"gather_elems: {name} must be a contiguous 1-D int32 or "
                f"int64 tensor, got {getattr(t, 'dtype', type(t))} "
                f"{tuple(getattr(t, 'shape', ()))}")
    dev, home = ids.device, table.device
    on_host = dev.type == "cuda" and home.type == "cpu"
    if on_host and not table.is_pinned():
        raise ValueError("gather_elems reads a host table from the card "
                         "only when it lies in pinned memory")
    if not on_host and home != dev:
        raise ValueError(f"gather_elems: a table on {home} and ids on {dev}")
    if dev.type == "cpu":
        return gather_elems_plain(table, ids)
    if dev.type != "cuda":
        raise ValueError(f"gather_elems runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty(n, dtype=table.dtype, device=dev)
    if n == 0:
        return out
    if table.shape[0] < 1:
        raise ValueError("gather_elems: ids index an empty table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_gather_elems(
            table.data_ptr(), int(on_host), table.element_size(),
            ids.data_ptr(), ids.element_size(), n, table.shape[0],
            out.data_ptr(), stream)
    _build.launched(err, "gather_elems", "gather_elems_kernel")
    return out


def _implied_ids(start, count, width):
    """The flat ids a span gather reads: ``start[i] + j`` where ``j <
    count[i]``, else -1 (``[bs, width]`` int64)."""
    j = torch.arange(width, dtype=torch.int64, device=start.device)
    return torch.where(j < count[:, None], start[:, None] + j, -1)


def gather_segments_plain(table, start, count, width):
    """Plain version of :func:`gather_segments`: :func:`gather_elems_plain`
    over the implied ids, an fp32 table read as its int32 words."""
    if table.dtype == torch.float32:
        return gather_segments_plain(table.view(torch.int32), start, count,
                                     width).view(torch.float32)
    ids = _implied_ids(start, count, width).reshape(-1)
    return gather_elems_plain(table, ids).reshape(start.shape[0], width)


@_build.recorded("gather_segments")
def gather_segments(table, start, count, width, out=None):
    """``out[i, j] = table[start[i] + j]`` for ``j < count[i]``, else -1
    (for fp32 its bits, a NaN): each seed's span of consecutive elements
    of a contiguous 1-D int32, int64 or fp32 ``table`` (the sampler's
    ``indptr`` heads, the weighted pool's weights). ``start`` is a
    contiguous 1-D int64 tensor, ``count`` an int32 one of the same
    length on the same device (0 reads nothing for its seed); ``width``
    the columns. It reads exactly what :func:`gather_elems` reads over
    the ids ``where(j < count, start + j, -1)`` and returns the same
    values, but builds no id array and reads nothing past a seed's
    ``count``. The result, ``[bs, width]`` of the table's dtype, lies on
    ``start``'s device (``out``, contiguous, is filled and returned). On
    a card the table lies on that card or in pinned host memory; on CPU
    tensors the plain version runs."""
    if torch.is_tensor(table) and table.dtype == torch.float32:
        if out is not None and (not torch.is_tensor(out)
                                or out.dtype != torch.float32):
            raise ValueError("gather_segments: out must be fp32 for an "
                             "fp32 table")
        return gather_segments(
            table.view(torch.int32), start, count, width,
            None if out is None else out.view(torch.int32)) \
            .view(torch.float32)
    if not torch.is_tensor(table) or table.dtype not in _ELEM_DTYPES \
            or table.dim() != 1 or not table.is_contiguous():
        raise ValueError(
            "gather_segments: table must be a contiguous 1-D int32, int64 "
            f"or fp32 tensor, got {getattr(table, 'dtype', type(table))} "
            f"{tuple(getattr(table, 'shape', ()))}")
    for t, name, dtype in ((start, "start", torch.int64),
                           (count, "count", torch.int32)):
        if not torch.is_tensor(t) or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"gather_segments: {name} must be a contiguous "
                             f"1-D {dtype} tensor")
    if count.shape != start.shape or count.device != start.device:
        raise ValueError("gather_segments: start and count differ in "
                         "length or device")
    width = int(width)
    if width < 0:
        raise ValueError(f"gather_segments: width {width} is negative")
    dev, home = start.device, table.device
    on_host = dev.type == "cuda" and home.type == "cpu"
    if on_host and not table.is_pinned():
        raise ValueError("gather_segments reads a host table from the card "
                         "only when it lies in pinned memory")
    if not on_host and home != dev:
        raise ValueError(f"gather_segments: a table on {home} and spans on "
                         f"{dev}")
    n = start.shape[0]
    if out is not None:
        _check_out(out, n, width, table.dtype, dev)
    if dev.type == "cpu":
        got = gather_segments_plain(table, start, count, width)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"gather_segments runs on cuda or cpu, not {dev}")
    if out is None:
        out = torch.empty((n, width), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    if table.shape[0] < 1:
        raise ValueError("gather_segments: spans index an empty table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_gather_segments(
            table.data_ptr(), int(on_host), table.element_size(),
            start.data_ptr(), count.data_ptr(), n, table.shape[0], width,
            out.data_ptr(), stream)
    _build.launched(err, "gather_elems", "gather_segments_kernel")
    return out


# -- the sharded table --------------------------------------------------------

def _block_layout(blk):
    """``(base, row stride in bytes, on_host)`` of one block of a
    sharded tier, checked."""
    data, scale, _, stride = _leaves(blk)
    if scale is not None and stride is None:
        raise ValueError("an int8 block of a sharded tier is packed "
                         "(quant.pack)")
    if stride is None:
        stride = data.shape[1] * data.element_size()
    on_host = data.device.type == "cpu"
    return data.data_ptr(), stride, on_host


def _sharded_layout(tier):
    """The blocks' ``(bases, stride, on_host flags)``; every block has the
    first one's kind, dtype, width and stride."""
    first = tier.shards[0]
    kind = (quant.is_quantized(first), quant.tier_dtype(first),
            quant.tier_dim(first))
    bases, strides, hosts = [], set(), []
    for blk in tier.shards:
        if (quant.is_quantized(blk), quant.tier_dtype(blk),
                quant.tier_dim(blk)) != kind:
            raise ValueError("the blocks of a sharded tier share one kind, "
                             "dtype and width")
        if quant.tier_rows(blk) == 0:       # never read
            bases.append(0)
            hosts.append(False)
            continue
        base, stride, on_host = _block_layout(blk)
        bases.append(base)
        strides.add(stride)
        hosts.append(on_host)
    if len(strides) > 1:
        raise ValueError(f"the blocks of a sharded tier share one row "
                         f"stride, got {sorted(strides)}")
    return bases, strides.pop() if strides else 16, hosts


def _sharded_table(tier):
    """The device table of a sharded tier on its card, built once:
    ``(addresses, offsets, address bits, stride, any block on the
    host)``, the first two int64 tensors on ``tier.device``. A block in
    host memory must be pinned; its address is the device's mapping of
    it."""
    if tier.table is not None:
        return tier.table
    bases, stride, hosts = _sharded_layout(tier)
    addrs = []
    for blk, base, on_host in zip(tier.shards, bases, hosts):
        if quant.tier_rows(blk) == 0:
            addrs.append(0)                 # an empty block is never read
            continue
        if on_host and not quant.tier_parts(blk)[0].is_pinned():
            raise ValueError("gather_rows_sharded reads a host block from "
                             "the card only when it lies in pinned memory")
        mapped = ctypes.c_void_p()
        with torch.cuda.device(tier.device):
            err = _lib().qt_device_address(base, int(on_host),
                                           ctypes.byref(mapped))
        if err != 0:
            raise RuntimeError(f"gather_rows_sharded: no device address "
                               f"for block {len(addrs)} (CUDA error {err})")
        addrs.append(mapped.value or 0)
    bits = stride
    for a in addrs:
        bits |= a
    tier.table = (
        torch.tensor(addrs, dtype=torch.int64).to(tier.device),
        torch.tensor(tier.offsets, dtype=torch.int64).to(tier.device),
        bits, stride, any(hosts))
    return tier.table


def prepare_sharded(tier):
    """Check a sharded tier and, on a card, build its device table now
    (one small copy), so that no lookup makes one."""
    if tier.device.type == "cuda":
        _sharded_table(tier)
    else:
        _sharded_layout(tier)
    return tier


def gather_rows_sharded_plain(tier, ids, out=None):
    """Plain version of :func:`gather_rows_sharded`: route each id
    (clamped into the table) to its block by the offsets, ``index_select``
    the block's rows on the block's device, decode, and write them at
    the id's positions; with ``out``, only where the id is not
    negative."""
    n, dim = ids.shape[0], tier.dim
    total = tier.rows
    idx = ids.long().clamp(0, max(total - 1, 0))
    off = torch.tensor(tier.offsets, dtype=torch.int64, device=ids.device)
    block = torch.searchsorted(off[1:-1], idx, right=True)
    rows = torch.zeros((n, dim), dtype=quant.tier_dtype(tier),
                       device=ids.device)
    for s, blk in enumerate(tier.shards):
        at = torch.nonzero(block == s).reshape(-1)
        if at.numel():
            home = quant.tier_parts(blk)[0].device
            local = (idx[at] - tier.offsets[s]).to(home)
            rows.index_copy_(0, at, quant.gather_rows(blk, local)
                             .to(ids.device))
    if out is None:
        return rows
    return out.copy_(torch.where((ids >= 0)[:, None], rows, out))


@_build.recorded("gather_rows_sharded")
def gather_rows_sharded(tier, ids, out=None):
    """``out[i] = tier[ids[i]]`` over a ``quant.ShardedTier`` in one
    launch. Its blocks lie on ``tier.device`` (the lookups' card), on
    cards it can reach (:func:`enable_peer_access`) or in pinned host
    memory; they are contiguous fp32, bf16, fp16 or int8 rows, or packed
    int8 rows (decoded to fp32 as the other gathers decode them). ``ids``
    is a 1-D int32 tensor on ``tier.device`` (int64 is cast). Without
    ``out`` every id must lie in the table (the kernel clamps one outside
    it); with ``out`` (contiguous ``[n, d]`` of the rows' dtype on that
    device) a negative id leaves its row untouched and reads nothing.
    CPU ids run the plain version."""
    if not quant.is_sharded(tier):
        raise ValueError("gather_rows_sharded takes a quant.ShardedTier")
    if torch.is_tensor(ids) and ids.dtype == torch.int64:
        ids = ids.to(torch.int32)
    dev = tier.device
    _check_1d_int32(ids, "ids", dev)
    n, dim = ids.shape[0], tier.dim
    dtype = quant.tier_dtype(tier)
    if out is not None:
        _check_out(out, n, dim, dtype, dev)
    if dev.type == "cpu":
        return gather_rows_sharded_plain(tier, ids, out)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows_sharded runs on cuda or cpu, not "
                         f"{dev}")
    if tier.rows < 1:
        raise ValueError("gather_rows_sharded: ids index an empty table")
    addrs, offs, bits, stride, on_host = _sharded_table(tier)
    skip = int(out is not None)
    if out is None:
        out = torch.empty((n, dim), dtype=dtype, device=dev)
    if n == 0:
        return out
    first = tier.shards[0]
    packed = quant.is_quantized(first)
    side = quant.sidecar_offset(dim) if packed else -1
    row_bytes = dim * quant.tier_parts(first)[0].element_size()
    if packed:
        design, word = "loop", 0            # not read for packed rows
        kernel = packed_kernel(on_host, sharded=True)
    else:
        design, word, kernel = raw_launch(tier, out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_gather_rows_sharded(
            addrs.data_ptr(), offs.data_ptr(), len(tier.shards), bits,
            int(on_host), ids.data_ptr(), n, stride, row_bytes, dim, side,
            out.data_ptr(), skip, RAW_DESIGNS[design], word, stream)
    _build.launched(err, "gather_rows_sharded", kernel)
    return out


def enable_peer_access(device: int, peer: int) -> None:
    """Let card ``device`` read and write the memory of card ``peer``
    (two different CUDA ordinals); enabling it again is no error."""
    err = _lib().qt_enable_peer_access(int(device), int(peer))
    if err != 0:
        raise RuntimeError(f"enabling peer access from cuda:{device} to "
                           f"cuda:{peer} failed with CUDA error {err}")
