"""Tiered row storage with one gather (counterpart of
``quiver_tpu/shard_tensor.py``; the reference's ShardTensor,
shard_tensor.py and quiver_feature.cu:143-293).

A shard lives on a card (``append(t, device >= 0)``: on ``cuda:(device %
cards)``, the JAX package's ``device % len(devices)``) or in host memory
(``append(t, -1)``, pinned), with contiguous logical row ranges, as in
the reference's append model. As in the JAX package, storage is one
contiguous table per placement group, grown at append time: a group for
each device number and one for the host (an int8 group packed by
``quant.pack`` wherever it lies). A device number past the card count
keeps a group of its own on the card it wraps to, as a clique names one
card several times. The groups are the blocks of one
``quant.ShardedTier``, and a lookup is one launch of
``ops/kernels/gather.py: gather_rows_sharded`` on the store's card: each
id finds its block by the offsets, and the row is read from the local
card, a peer card or pinned host memory (the reference's
``quiver_tensor_gather``). When the appends interleave the groups, the
ids are first moved to the groups' order on the card (``searchsorted``
over the shard offsets). No id goes back to the host. Invalid ids (< 0 or
>= len) give zero rows. The groups' cards are put in peer access
(``utils.topo.init_p2p``).

``dtype_policy`` ("bf16", "fp16", "int8") stores appended blocks narrow
and dequantizes only the gathered rows; an int8 decode rounds the
multiply, then the add, wherever the row lies (the JAX package's host
group decodes through float64 and rounds once).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .ops import quant
from .ops.kernels.gather import gather_rows_sharded, prepare_sharded
from .utils.device import resolve_device
from .utils.placement import pinned_put, register_host, share_host
from .utils.sizes import parse_size
from .utils.topo import init_p2p


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
    """Logical shard: its group (the device number, ``-1`` the host) and
    its row span inside that group's table."""

    __slots__ = ("device", "rows", "base")

    def __init__(self, device: int, rows: int, base: int):
        self.device = device
        self.rows = rows
        self.base = base


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
    ``current_device`` unless the caller passes ``"cpu"``, where every
    group stays a CPU tensor and the gather runs its plain version)."""

    def __init__(self, current_device: int = 0,
                 shard_tensor_config: Optional[ShardTensorConfig] = None,
                 dtype_policy=None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device(
                "cuda", current_device % torch.cuda.device_count())
        self.current_device = current_device
        self.config = shard_tensor_config or ShardTensorConfig({})
        self.dtype_policy = quant.resolve_policy(dtype_policy)
        self._shards: List[_Shard] = []
        self._groups: Dict[int, object] = {}   # group -> its rows, placed
        self._blocks = []              # the groups in first-append order
        self._offsets = [0]
        self._dim = None
        self._dtype = None             # input dtype (append validation)
        self._out_dtype = None         # dequantized lookup dtype
        self._tier = None              # the groups as one ShardedTier
        self._remap = None             # logical -> tier ids, if they differ

    def _card(self, device: int) -> torch.device:
        """Where the rows of ``append(t, device)`` lie."""
        if device < 0 or self.device.type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", device % torch.cuda.device_count())

    # -- construction -------------------------------------------------------
    def append(self, tensor, device: int):
        """``device >= 0``: the rows go to that device's group, on card
        ``device % cards``; ``device == -1``: to the host group
        (pinned)."""
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
        key = max(device, -1)
        card = self._card(key)
        prev = self._groups.get(key)
        base = 0 if prev is None else quant.tier_rows(prev)
        rows = _cat_tier(prev, quant.tree_map_tier(lambda t: t.to(card),
                                                   block))
        if key < 0:
            rows = pinned_put(rows, self.device, "the ShardTensor host "
                              "group")
        elif quant.is_quantized(rows):
            rows = quant.pack(rows, device=card)
        else:
            rows = rows.contiguous()
        self._groups[key] = rows
        self._shards.append(_Shard(key, int(arr.shape[0]), base))
        self._offsets.append(self._offsets[-1] + int(arr.shape[0]))
        if card.type == "cuda":
            init_p2p([self.device, card])
        self._build_index()

    def _build_index(self):
        """The groups as one ``ShardedTier`` (its device table built
        now), and, when the appends interleave the groups, the per-shard
        shifts from logical ids to the tier's rows on the store's device:
        O(#shards), made at append time so that a lookup copies nothing
        to the card."""
        self._blocks = list(self._groups.values())
        start, offsets = {}, [0]
        for key, rows in self._groups.items():
            start[key] = offsets[-1]
            offsets.append(offsets[-1] + quant.tier_rows(rows))
        self._tier = prepare_sharded(quant.ShardedTier(
            self._blocks, offsets, self.device))
        shift = [start[s.device] + s.base - self._offsets[i]
                 for i, s in enumerate(self._shards)]
        self._remap = None if not any(shift) else (
            torch.tensor(self._offsets[1:-1], dtype=torch.int64,
                         device=self.device),
            torch.tensor(shift, dtype=torch.int64, device=self.device))

    # -- gather -------------------------------------------------------------
    def __getitem__(self, ids):
        if not self._shards:
            raise ValueError("empty ShardTensor")
        ids = (ids if torch.is_tensor(ids)
               else torch.as_tensor(np.asarray(ids))).to(self.device)
        ids = ids.to(torch.int64).reshape(-1)
        valid = (ids >= 0) & (ids < self._offsets[-1])
        if self._remap is not None:
            inner, shift = self._remap
            ids = ids + shift[torch.searchsorted(inner, ids, right=True)]
        out = torch.zeros((ids.shape[0], self._dim), dtype=self._out_dtype,
                          device=self.device)
        # every group, on the card, a peer or the host, in one launch; an
        # invalid id is -1, reads nothing and keeps its zero row
        return gather_rows_sharded(
            self._tier, torch.where(valid, ids, -1).to(torch.int32), out=out)

    # -- shape protocol ------------------------------------------------------
    @property
    def shape(self):
        return (self._offsets[-1], self._dim or 0)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def _shard_data(self, i: int):
        """Shard ``i``'s rows, dequantized: consumers see values,
        whatever the width."""
        s = self._shards[i]
        return quant.dequantize(quant.tree_map_tier(
            lambda t: t[s.base:s.base + s.rows], self._groups[s.device]))

    def stored(self, host: bool):
        """The stored rows of the device groups (``host=False``, in the
        order of their first appends) or of the host group, as CPU
        tensors (an int8 store's codes and sidecars as contiguous
        leaves): JAX's device groups and host group. None without such
        rows."""
        parts = [rows for key, rows in self._groups.items()
                 if (key < 0) == host]
        if not parts:
            return None
        if quant.is_quantized(parts[0]):
            return quant.QuantizedTensor(*(
                torch.cat([getattr(p, k).cpu() for p in parts])
                for k in ("data", "scale", "zero")))
        return torch.cat([p.cpu() for p in parts])

    @property
    def device_tensor_list(self):
        """Each device group's rows, dequantized."""
        return [quant.dequantize(rows) for key, rows in self._groups.items()
                if key >= 0]

    @property
    def cpu_tensor(self):
        """The host group's rows, dequantized, as a CPU copy."""
        host = self.stored(host=True)
        if host is None:
            return None
        out = quant.dequantize(host)
        return torch.empty(out.shape, dtype=out.dtype).copy_(out)

    # -- sharing -------------------------------------------------------------
    def share_ipc(self):
        # blocks travel dequantized, with the policy beside them, so the
        # receiver quantizes again instead of storing full width
        return ([(self._shard_data(i), s.device, s.rows)
                 for i, s in enumerate(self._shards)], self.dtype_policy)

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

    def ipc_state(self) -> dict:
        """The store as ``multiprocessing.reductions`` sends it to a
        ``torch.multiprocessing`` worker: its groups as they are stored,
        card groups by CUDA IPC and the host group in shared memory
        (moved there once, and pinned again: ``utils.placement.
        share_host``), so nothing is copied or re-quantized."""
        if -1 in self._groups:
            self._groups[-1] = share_host(self._groups[-1], self.device)
            self._build_index()
        state = dict(self.__dict__)
        state["_blocks"], state["_tier"], state["_remap"] = [], None, None
        return state

    @classmethod
    def from_ipc_state(cls, state: dict) -> "ShardTensor":
        """The worker's side of :meth:`ipc_state`: the host group pinned
        in this process, the gather's table built on its card."""
        st = cls.__new__(cls)
        st.__dict__.update(state)
        if -1 in st._groups:
            register_host(st._groups[-1], st.device)
        cards = {quant.tier_parts(b)[0].device for b in st._groups.values()}
        if st.device.type == "cuda":
            init_p2p([st.device] + [c for c in cards if c.type == "cuda"])
        st._build_index()
        return st
