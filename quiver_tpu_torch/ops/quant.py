"""Per-tier dtype policy with fused dequant (counterpart of
``quiver_tpu/ops/quant.py``).

``None``/"fp32" stores rows as they are; "bf16"/"fp16" are pure casts;
"int8" is per-row affine quantization, a :class:`QuantizedTensor` of
``(data int8 [n, d], scale [n, 1], zero [n, 1])`` with the ``+128`` code
offset folded into ``zero``, so dequant is ``code * scale + zero``.
Dequant is a multiply rounded and then an add rounded, never one fused
multiply-add: the CUDA hot-hop kernel does the same, which keeps the
two bit-identical.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

POLICIES = (None, "fp32", "fp16", "bf16", "int8")

# per-row sidecar bytes for int8: fp32 scale + fp32 zero-point
_SIDECAR_BYTES = 8


def resolve_policy(policy):
    """Canonicalize a policy name: None/'fp32' -> None (identity)."""
    if policy in (None, "fp32", "float32"):
        return None
    if policy in ("bf16", "bfloat16"):
        return "bf16"
    if policy in ("fp16", "float16"):
        return "fp16"
    if policy == "int8":
        return "int8"
    raise ValueError(
        f"unknown dtype policy {policy!r}; expected one of "
        f"{[p for p in POLICIES if p]} or None")


class QuantizedTensor(NamedTuple):
    """int8 rows + per-row affine sidecars; dequant is
    ``code * scale + zero``."""

    data: torch.Tensor    # [n, d] int8 code in [-128, 127]
    scale: torch.Tensor   # [n, 1] dequant slope, in the logical dtype
    zero: torch.Tensor    # [n, 1] row bias (the value of code 0)

    @property
    def shape(self):
        return self.data.shape

    def to(self, *args, **kwargs) -> "QuantizedTensor":
        return QuantizedTensor(*(t.to(*args, **kwargs) for t in self))


def is_quantized(t) -> bool:
    return isinstance(t, QuantizedTensor)


def storage_itemsize(policy) -> float:
    """Stored bytes per element under ``policy`` (sidecars excluded)."""
    return {None: 4, "bf16": 2, "fp16": 2, "int8": 1}[resolve_policy(policy)]


def row_bytes(dim: int, policy=None, base_itemsize: int = 4) -> int:
    """Stored bytes per row under ``policy``, sidecars included: the
    currency of host-tier traffic, and what the hot-tier sizing divides
    the byte budget by."""
    p = resolve_policy(policy)
    if p is None:
        return dim * base_itemsize
    if p == "int8":
        return dim + _SIDECAR_BYTES
    return dim * 2                      # bf16 / fp16


def quantize(x, policy):
    """Encode ``x`` (a tensor, or a numpy array that becomes one) under
    ``policy``. Plain-cast policies return a cast tensor; "int8" returns
    a :class:`QuantizedTensor` whose sidecars keep ``x``'s float dtype."""
    x = torch.as_tensor(x)
    p = resolve_policy(policy)
    if p is None:
        return x
    if p in ("bf16", "fp16"):
        return x.to(torch.bfloat16 if p == "bf16" else torch.float16)
    xf = x.to(torch.float32)
    mn = xf.amin(dim=1, keepdim=True)
    mx = xf.amax(dim=1, keepdim=True)
    scale = (mx - mn) / 255.0
    # constant rows (mn == mx) get slope 1 so dequant returns mn exactly
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    code = torch.clamp(torch.round((xf - mn) / scale) - 128, -128, 127)
    zero = mn + 128.0 * scale
    side_dt = x.dtype if x.is_floating_point() else torch.float32
    return QuantizedTensor(code.to(torch.int8), scale.to(side_dt),
                           zero.to(side_dt))


def dequantize(t, dtype=None):
    """Decode rows. Plain tensors pass through (optionally cast)."""
    if not is_quantized(t):
        return t if dtype is None else t.to(dtype)
    out = t.data.to(t.scale.dtype) * t.scale + t.zero
    return out if dtype is None else out.to(dtype)


def tier_rows(t) -> int:
    return int(t.data.shape[0] if is_quantized(t) else t.shape[0])


def tier_dim(t) -> int:
    return int(t.data.shape[1] if is_quantized(t) else t.shape[1])


def tier_dtype(t) -> torch.dtype:
    """The dtype lookups of this tier produce (dequantized width)."""
    return t.scale.dtype if is_quantized(t) else t.dtype


def tier_parts(t):
    """``(codes, scale, zero)`` for a quantized tier, ``(t, None, None)``
    for a plain tensor: the storage leaves a kernel takes."""
    if is_quantized(t):
        return t.data, t.scale, t.zero
    return t, None, None


def row_read_bytes(t) -> int:
    """Bytes one row lookup of this tier moves from storage."""
    if is_quantized(t):
        return int(tier_dim(t) + t.scale.element_size()
                   + t.zero.element_size())
    return int(tier_dim(t) * t.element_size())


def gather_rows(t, ids: torch.Tensor) -> torch.Tensor:
    """``t[ids]`` with dequantization fused; ``ids`` must already be in
    range (callers own masking)."""
    ids = ids.long()
    if not is_quantized(t):
        return t.index_select(0, ids)
    code = t.data.index_select(0, ids)
    scale = t.scale.index_select(0, ids)
    zero = t.zero.index_select(0, ids)
    return code.to(scale.dtype) * scale + zero


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def take_np(t, ids) -> torch.Tensor:
    """The host path's fancy-index and dequant: rows ``ids`` (in range)
    of a tier held in host memory (CPU tensors or numpy arrays), as a
    CPU tensor. Unlike the JAX package's ``take_np``, which decodes
    through float64 and rounds once, this rounds the multiply and then
    the add, as the kernels and :func:`gather_rows` do, so a row reads
    the same bits from either tier."""
    return gather_rows(tree_map_tier(torch.as_tensor, t),
                       torch.as_tensor(ids))


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (or a torch one, returned as it is) as torch's."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def decode_np(codes: np.ndarray, scale: np.ndarray,
              zero: np.ndarray) -> np.ndarray:
    """The dequant of numpy int8 rows: ``code * scale`` rounded, then
    ``+ zero`` rounded, in the sidecars' dtype; the bits of
    :func:`take_np`, :func:`gather_rows` and the kernels. The disk tier's
    reads and its staging workers decode with it, in numpy, so that they
    make no torch call."""
    return codes.astype(scale.dtype) * scale + zero


def tree_map_tier(fn, t):
    """Apply ``fn`` to the tier's storage leaves (placement, pinning)
    keeping the ``QuantizedTensor`` wrapper."""
    if is_quantized(t):
        return QuantizedTensor(fn(t.data), fn(t.scale), fn(t.zero))
    return fn(t)


# -- the packed int8 host tier ------------------------------------------------
# Row r of one uint8 buffer [n, stride] holds the codes in bytes [0, d),
# the fp32 scale in [c, c + 4) and the fp32 zero in [c + 4, c + 8), with
# c = sidecar_offset(d), then zeros up to the stride. The card reads a
# host row over PCIe, where the count of read requests, not bytes, sets
# the pace: a packed row of at most 128 bytes is one aligned request,
# where codes and two sidecar arrays cost three or more.

def sidecar_offset(dim: int) -> int:
    """Byte offset of the scale in a packed row: ``dim`` rounded up to
    4, or to 16 where the 8 sidecar bytes would cross a 16-byte word
    (the gather kernel takes both from one word)."""
    c = -(-dim // 4) * 4
    return c if c % 16 <= 8 else -(-dim // 16) * 16


def packed_stride(dim: int) -> int:
    """The row stride in bytes of a packed tier of width ``dim``: the
    row's bytes rounded up to a power of two up to 128, past that to a
    multiple of 128, so that no row crosses a 128-byte line it does not
    have to (a 100-wide row takes 128 bytes)."""
    need = sidecar_offset(dim) + 8
    if need > 128:
        return -(-need // 128) * 128
    return max(16, 1 << (need - 1).bit_length())


def pack(t: QuantizedTensor, stride: Optional[int] = None,
         pin: bool = False) -> QuantizedTensor:
    """The int8 tier ``t`` (fp32 sidecars) copied into one host buffer of
    packed rows (pinned when ``pin``), returned as the same
    ``QuantizedTensor`` whose three leaves are strided views into that
    buffer. ``stride`` (a multiple of 16 that holds the row) defaults to
    :func:`packed_stride`."""
    data, scale, zero = (x.cpu() for x in t)
    if data.dtype != torch.int8 or data.dim() != 2 \
            or scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError("pack takes int8 [n, d] codes with fp32 sidecars")
    n, d = data.shape
    side = sidecar_offset(d)
    stride = packed_stride(d) if stride is None else stride
    if stride % 16 or stride < side + 8:
        raise ValueError(f"a packed row of width {d} needs a stride that "
                         f"is a multiple of 16 of at least {side + 8}, "
                         f"not {stride}")
    buf = torch.zeros((n, stride), dtype=torch.uint8, pin_memory=pin)
    buf[:, :d] = data.view(torch.uint8)
    for off, side_t in ((side, scale), (side + 4, zero)):
        buf[:, off:off + 4] = side_t.reshape(n, 1).contiguous() \
            .view(torch.uint8)
    return QuantizedTensor(buf[:, :d].view(torch.int8),
                           buf[:, side:side + 4].view(torch.float32),
                           buf[:, side + 4:side + 8].view(torch.float32))


def default_cold_budget(n: int) -> int:
    """The tiered lookup's default per-batch host-row budget (shared by
    ``Feature.lookup_tiered`` and ``dedup_feature_gather``)."""
    return max(n // 4, 256)


def dedup_rows_read(ids, budget: Optional[int] = None,
                    cold_count: Optional[int] = None) -> int:
    """The host rows the dedup tiered lookup's branch structure allows
    for one batch, as the JAX package counts them: ``budget`` on the
    narrow path; on unique overflow the cold-compaction path, still
    ``budget`` unless the raw cold-slot count (``cold_count``; None
    assumes every slot may be cold) overflows too, and then the whole
    batch."""
    ids = _host(ids)
    n = int(ids.shape[0])
    if budget is None:
        budget = default_cold_budget(n)
    if budget >= n:
        return n
    if np.unique(ids[ids >= 0]).size <= budget:
        return budget
    if cold_count is None:
        cold_count = n
    return budget if cold_count <= budget else n


class HotPlan(NamedTuple):
    """Bandwidth-aware hot-tier sizing under a dtype policy."""

    rows: int                    # hot rows the budget holds under policy
    row_bytes: int               # stored bytes/row (sidecars included)
    expected_hit_rate: Optional[float]   # degree-mass share, if degrees
    fp32_rows: int               # the width-blind sizing, for comparison
    fp32_hit_rate: Optional[float]


def plan_hot_capacity(budget_bytes: int, total_rows: int, dim: int,
                      policy=None, base_itemsize: int = 4,
                      degree=None) -> HotPlan:
    """Hot-tier capacity from (byte budget, dtype policy, degrees):
    narrow rows hold 2-4x more rows in one budget, and under
    degree-proportional access the expected hit rate is the cached rows'
    share of the total degree mass, beside the fp32 sizing's."""
    rb = row_bytes(dim, policy, base_itemsize)
    rows = min(total_rows, budget_bytes // max(rb, 1))
    rb32 = dim * base_itemsize
    rows32 = min(total_rows, budget_bytes // max(rb32, 1))
    hit = hit32 = None
    if degree is not None and total_rows:
        deg = np.sort(_host(degree).astype(np.float64))[::-1]
        mass = np.concatenate([[0.0], np.cumsum(deg)])
        total = mass[-1] or 1.0
        hit = float(mass[min(rows, deg.size)] / total)
        hit32 = float(mass[min(rows32, deg.size)] / total)
    return HotPlan(int(rows), int(rb), hit, int(rows32), hit32)

