"""The least bytes a kernel needs on a run's data: a frozen copy of the
formulas the program's cost model prices its kernels with, so that a
later change to the program does not move the yardstick.

Each input byte the work needs is counted once and each output byte
written once, whatever the kernel reads again.
"""

from __future__ import annotations

import torch


def gather_rows_bytes(ids: torch.Tensor, row_bytes: int, dim: int):
    """``(table bytes, device bytes, distinct rows)`` of a row gather:
    each distinct live row read once from its table, the ids read and
    the fp32 rows written on the device. Negative ids read nothing."""
    live = ids[ids >= 0]
    distinct = int(torch.unique(live).numel())
    return distinct * row_bytes, ids.shape[0] * 4 + live.shape[0] * 4 * dim, \
        distinct
