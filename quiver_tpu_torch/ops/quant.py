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

from typing import NamedTuple

import torch

POLICIES = (None, "fp32", "fp16", "bf16", "int8")


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

