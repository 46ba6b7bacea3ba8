"""Tiered row storage with one gather, single card (counterpart of
``quiver_tpu/shard_tensor.py``).

A shard lives on the card (``append(t, device >= 0)``) or in host memory
(``append(t, -1)``), with contiguous logical row ranges, as in the
reference's append model. Each placement group is one contiguous table,
grown at append time: on one card every device shard lands in the same
group (the JAX package maps ``device % len(devices)``, which on one
device is 0), and the host group is pinned (an int8 group packed by
``quant.pack``). A lookup buckets its ids with ``searchsorted`` over the
shard offsets, gathers the device group's rows on the card, and has the
card read the host group's rows itself: ``ops/kernels/gather.py:
gather_rows`` over the pinned table, with device ids that are -1
wherever a row is not in the host group (the reference's UVA gather,
what the ``Feature`` store's offload tier does). No id goes back to the
host. Invalid ids (< 0 or >= len) give zero rows.

``dtype_policy`` ("bf16", "fp16", "int8") stores appended blocks narrow
and dequantizes only the gathered rows; an int8 decode rounds the
multiply, then the add, on either group (the JAX package's host group
decodes through float64 and rounds once).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .ops import quant
from .ops.kernels.gather import gather_rows
from .utils.device import resolve_device
from .utils.placement import pinned_put
from .utils.sizes import parse_size


@dataclass
class ShardTensorConfig:
    """Per-device byte budgets (reference: shard_tensor.py:35-48)."""

    device_memory_budget: Dict[int, object] = field(default_factory=dict)

    @property
    def device_list(self):
        return list(self.device_memory_budget.keys())

    def budget_bytes(self, device: int) -> int:
        return parse_size(self.device_memory_budget.get(device, 0))


class _Shard:
    """Logical shard: its group (0 the card, -1 the host) and its row
    span inside that group's table."""

    __slots__ = ("device", "rows", "base")

    def __init__(self, device: int, rows: int, base: int):
        self.device = device
        self.rows = rows
        self.base = base


def _compact(tier):
    """A placed (pinned, maybe packed) host group as plain contiguous
    CPU leaves, to grow it."""
    return quant.tree_map_tier(
        lambda t: torch.empty(t.shape, dtype=t.dtype).copy_(t), tier)


def _cat_tier(prev, new):
    """Concatenate two tier blocks leaf-wise (int8 sidecars grow with
    the codes)."""
    if prev is None:
        return new
    if quant.is_quantized(new):
        return quant.QuantizedTensor(
            *(torch.cat([a, b]) for a, b in zip(prev, new)))
    return torch.cat([prev, new])


class ShardTensor:
    """``ShardTensor(current_device, shard_tensor_config, dtype_policy,
    device)``: the JAX package's constructor, plus ``device`` (the card
    unless the caller passes ``"cpu"``, where the host group stays a
    plain CPU tensor and the gather runs its plain version)."""

    def __init__(self, current_device: int = 0,
                 shard_tensor_config: Optional[ShardTensorConfig] = None,
                 dtype_policy=None, device=None):
        self.device = resolve_device(device)
        self.current_device = current_device
        self.config = shard_tensor_config or ShardTensorConfig({})
        self.dtype_policy = quant.resolve_policy(dtype_policy)
        self._shards: List[_Shard] = []
        self._offsets = [0]
        self._dim = None
        self._dtype = None             # input dtype (append validation)
        self._out_dtype = None         # dequantized lookup dtype
        self._dev_data = None          # the card's group
        self._host_data = None         # the host group, placed
        self._index = None             # lookup tensors, made on append

    # -- construction -------------------------------------------------------
    def append(self, tensor, device: int):
        """``device >= 0``: the rows go to the card's group;
        ``device == -1``: to the host group (pinned)."""
        arr = tensor if torch.is_tensor(tensor) \
            else torch.from_numpy(np.ascontiguousarray(np.asarray(tensor)))
        if arr.dim() != 2:
            raise ValueError("ShardTensor stores 2-D row blocks")
        if self._dim is None:
            self._dim = int(arr.shape[1])
            self._dtype = arr.dtype
        elif int(arr.shape[1]) != self._dim:
            raise ValueError("inconsistent feature dim")
        elif arr.dtype != self._dtype:
            # a group is one table; a mixed-dtype append would promote
            # (and maybe double) the whole store
            raise ValueError(
                f"inconsistent dtype: store is {self._dtype}, "
                f"append is {arr.dtype}")
        block = quant.quantize(arr, self.dtype_policy)
        if self._out_dtype is None:
            self._out_dtype = quant.tier_dtype(block)
        rows = int(arr.shape[0])
        if device >= 0:
            block = quant.tree_map_tier(
                lambda t: t.to(self.device).contiguous(), block)
            base = 0 if self._dev_data is None \
                else quant.tier_rows(self._dev_data)
            self._dev_data = _cat_tier(self._dev_data, block)
            self._shards.append(_Shard(0, rows, base))
        else:
            block = quant.tree_map_tier(lambda t: t.cpu(), block)
            prev = None if self._host_data is None \
                else _compact(self._host_data)
            base = 0 if prev is None else quant.tier_rows(prev)
            self._host_data = pinned_put(_cat_tier(prev, block),
                                         self.device, "the ShardTensor "
                                         "host group")
            self._shards.append(_Shard(-1, rows, base))
        self._offsets.append(self._offsets[-1] + rows)
        self._build_index()

    def _build_index(self):
        """The shard offsets, groups and bases on the card, for the id
        bucketing: O(#shards), made at append time so that a lookup
        copies nothing to the card."""
        put = lambda v: torch.tensor(v, dtype=torch.int64).to(self.device)
        self._index = {
            "inner": put(self._offsets[1:-1]),
            "offsets": put(self._offsets[:-1]),
            "group": put([s.device for s in self._shards]),
            "base": put([s.base for s in self._shards]),
        }

    # -- gather -------------------------------------------------------------
    def __getitem__(self, ids):
        if not self._shards:
            raise ValueError("empty ShardTensor")
        ix = self._index
        ids = (ids if torch.is_tensor(ids)
               else torch.as_tensor(np.asarray(ids))).to(self.device)
        ids = ids.to(torch.int64).reshape(-1)
        total = self._offsets[-1]
        valid = (ids >= 0) & (ids < total)
        clipped = ids.clamp(0, total - 1)
        # which shard owns each id, and its row in that shard's group
        shard = torch.searchsorted(ix["inner"], clipped, right=True)
        group = torch.where(valid, ix["group"][shard], -2)
        local = clipped - ix["offsets"][shard] + ix["base"][shard]
        dev_rows = 0 if self._dev_data is None \
            else quant.tier_rows(self._dev_data)
        if dev_rows:
            got = quant.gather_rows(self._dev_data,
                                    local.clamp(0, dev_rows - 1))
            out = torch.where((group == 0)[:, None], got, 0)
        else:
            out = torch.zeros((ids.shape[0], self._dim),
                              dtype=self._out_dtype, device=self.device)
        if self._host_data is not None and quant.tier_rows(self._host_data):
            # the card reads the host group's rows itself; -1 reads
            # nothing and leaves the row as it is
            hids = torch.where(group == -1, local, -1).to(torch.int32)
            out = gather_rows(self._host_data, hids, out=out.contiguous())
        return out

    # -- shape protocol ------------------------------------------------------
    @property
    def shape(self):
        return (self._offsets[-1], self._dim or 0)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def _shard_data(self, s: _Shard):
        store = self._host_data if s.device < 0 else self._dev_data
        # dequantized rows: consumers see values, whatever the width
        return quant.dequantize(quant.tree_map_tier(
            lambda t: t[s.base:s.base + s.rows], store))

    @property
    def device_tensor_list(self):
        return [self._shard_data(s) for s in self._shards if s.device >= 0]

    @property
    def cpu_tensor(self):
        """The host group's rows, dequantized, as a CPU copy."""
        if self._host_data is None:
            return None
        out = quant.dequantize(self._host_data)
        return torch.empty(out.shape, dtype=out.dtype).copy_(out)

    # -- in-process sharing (one process owns the card) ----------------------
    def share_ipc(self):
        # blocks travel dequantized, with the policy beside them, so the
        # receiver quantizes again instead of storing full width
        return ([(self._shard_data(s), s.device, s.rows)
                 for s in self._shards], self.dtype_policy)

    @classmethod
    def new_from_share_ipc(cls, handle, current_device: int = 0,
                           device=None):
        if (isinstance(handle, tuple) and len(handle) == 2
                and isinstance(handle[0], list)):
            items, policy = handle
        else:                       # handles without a policy
            items, policy = handle, None
        st = cls(current_device, dtype_policy=policy, device=device)
        for data, dev, _rows in items:
            st.append(data, dev)
        return st
