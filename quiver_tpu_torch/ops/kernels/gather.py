"""Row gather (counterpart of ``quiver_tpu/ops/pallas/gather.py``).

:func:`gather_rows` computes ``out[i] = feat[ids[i]]`` for a 2-D
contiguous fp32, bf16, fp16 or int8 table. On CUDA tensors it launches
the kernel of ``csrc/gather.cu`` (a warp per row, copying bytes in
16-byte words where the width and alignment allow); on CPU tensors it
runs the plain version :func:`gather_rows_plain`. Unlike the JAX
function, neither the width nor the id count is padded.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sample_kernel import _check_1d_int32

_LIB = "gather"
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8)


def _lib():
    lib = _build.load(_LIB)
    if not getattr(lib, "_qt_bound", False):
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.qt_gather_rows.argtypes = [p, p, ll, ll, ll, p, p]
        lib.qt_gather_rows.restype = ctypes.c_int
        lib.qt_gather_word_bytes.argtypes = [p, p, ll]
        lib.qt_gather_word_bytes.restype = ctypes.c_int
        lib._qt_bound = True
    return lib


def gather_rows_plain(feat, ids):
    """Plain version of :func:`gather_rows` (``gather_rows_reference``)."""
    return feat[ids.long()]


def word_bytes(feat, out) -> int:
    """The width of the words the kernel copies for ``feat`` into
    ``out``: 16, 4, 2 or 1 bytes."""
    row = feat.shape[1] * feat.element_size()
    return _lib().qt_gather_word_bytes(feat.data_ptr(), out.data_ptr(), row)


def gather_rows(feat, ids):
    """``out[i] = feat[ids[i]]`` with every id in ``[0, N)`` (the
    contract of ``gather.py``; the kernel clamps an id outside it into
    the table, and reads nothing outside). ``feat`` is a contiguous
    ``[N, D]`` fp32, bf16, fp16 or int8 tensor; ``ids`` a contiguous 1-D
    int32 tensor on the same device, int64 ids are cast."""
    if not torch.is_tensor(feat) or feat.dtype not in _DTYPES \
            or feat.dim() != 2 or not feat.is_contiguous():
        raise ValueError(
            "gather_rows takes a contiguous 2-D fp32, bf16, fp16 or int8 "
            f"table, got {getattr(feat, 'dtype', type(feat))} "
            f"{tuple(getattr(feat, 'shape', ()))}")
    dev = feat.device
    if torch.is_tensor(ids) and ids.dtype == torch.int64:
        ids = ids.to(torch.int32)
    _check_1d_int32(ids, "ids", dev)
    if dev.type == "cpu":
        return gather_rows_plain(feat, ids)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty((n, feat.shape[1]), dtype=feat.dtype, device=dev)
    if out.numel() == 0:
        return out
    if feat.shape[0] < 1:
        raise ValueError("gather_rows: ids index an empty table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().qt_gather_rows(
            feat.data_ptr(), ids.data_ptr(), n, feat.shape[0],
            feat.shape[1] * feat.element_size(), out.data_ptr(), stream)
    _build.launched(err, "gather_rows")
    return out
