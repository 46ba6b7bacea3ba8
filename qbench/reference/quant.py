"""The int8 row code of the tiered store, worked out again.

Each row is coded against its own minimum and maximum: ``scale = (max -
min) / 255`` (1 for a constant row), ``code = clamp(round((x - min) /
scale) - 128, -128, 127)`` and ``zero = min + 128 * scale``; a row
decodes as ``code * scale + zero`` in fp32.
"""

from __future__ import annotations

import torch


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32 ``[N, D]``) coded to int8 by rows and decoded."""
    mn = x.amin(dim=1, keepdim=True)
    mx = x.amax(dim=1, keepdim=True)
    scale = (mx - mn) / mx.new_tensor(255.0)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    code = torch.clamp(torch.round((x - mn) / scale) - 128, -128, 127)
    return code * scale + (mn + 128.0 * scale)
