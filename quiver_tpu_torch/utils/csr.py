"""CSR graph topology container (counterpart of ``quiver_tpu/utils/csr.py``).

Node ids are int32; ``indptr`` widens to int64 only when the edge count
needs it. Isolated tail nodes are kept when ``node_count`` is passed.
The tensors live on the card unless the caller passes ``device="cpu"``.

The JAX package keeps a topology whose offsets exceed int32 in host
numpy and says so with ``requires_host_sampling``, because JAX's default
32-bit mode would wrap them on the device. torch holds an int64
``indptr`` on the card as it is, so the port has no such case and no
counterpart of that method.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device

INT32_MAX = np.iinfo(np.int32).max


def index_dtype_for(count: int) -> torch.dtype:
    """Smallest integer dtype that can index ``count`` items."""
    return torch.int32 if count <= INT32_MAX else torch.int64


def _as_tensor(x, dtype, device):
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(device=device, dtype=dtype).contiguous()


def get_csr_from_coo(edge_index, node_count: Optional[int] = None):
    """COO ``edge_index`` (2, E) -> (indptr, indices, eid) on the device
    of ``edge_index``. ``eid[j]`` is the COO position of the edge stored
    at CSR slot ``j``."""
    edge_index = torch.as_tensor(edge_index)
    row, col = edge_index[0], edge_index[1]
    e = int(row.shape[0])
    if node_count is None:
        node_count = 0 if e == 0 else int(torch.maximum(row.max(),
                                                        col.max())) + 1
    node_dtype = index_dtype_for(max(node_count, 1))
    ptr_dtype = index_dtype_for(max(e, 1))
    order = torch.argsort(row, stable=True)
    indices = col[order].to(node_dtype)
    eid = order.to(ptr_dtype)
    row_sorted = row[order].contiguous()
    indptr = torch.searchsorted(
        row_sorted, torch.arange(node_count + 1, dtype=row_sorted.dtype,
                                 device=row_sorted.device)).to(ptr_dtype)
    return indptr, indices, eid


class CSRTopo:
    """CSR ``indptr``/``indices`` (+ optional ``eid`` edge-id map and
    ``feature_order`` hot-cache permutation), with ``degree``,
    ``node_count`` and ``edge_count``."""

    def __init__(self, edge_index=None, indptr=None, indices=None, eid=None,
                 node_count: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        if edge_index is not None:
            ei = _as_tensor(edge_index, torch.int64, self.device)
            self._indptr, self._indices, self._eid = get_csr_from_coo(
                ei, node_count)
        elif indptr is not None and indices is not None:
            e = int(len(indices))
            ptr_dtype = index_dtype_for(max(e, 1))
            self._indptr = _as_tensor(indptr, ptr_dtype, self.device)
            n = int(self._indptr.shape[0]) - 1
            self._indices = _as_tensor(indices, index_dtype_for(max(n, 1)),
                                       self.device)
            self._eid = _as_tensor(eid, ptr_dtype, self.device)
        else:
            raise ValueError("provide either edge_index or indptr+indices")
        self._feature_order = None
        self._bucket_meta = {}   # {step: ExactBucketMeta}, computed lazily

    @property
    def indptr(self) -> torch.Tensor:
        return self._indptr

    @property
    def indices(self) -> torch.Tensor:
        return self._indices

    @property
    def eid(self):
        return self._eid

    @property
    def feature_order(self):
        return self._feature_order

    @feature_order.setter
    def feature_order(self, order):
        self._feature_order = _as_tensor(order, torch.int32, self.device)

    @property
    def degree(self) -> torch.Tensor:
        return self._indptr[1:] - self._indptr[:-1]

    @property
    def node_count(self) -> int:
        return int(self._indptr.shape[0]) - 1

    @property
    def edge_count(self) -> int:
        return int(self._indices.shape[0])

    def exact_bucket_meta(self, step: int = 128):
        """The wide-exact sampler's degree-bucket split
        (``ops.sample.ExactBucketMeta``), computed once per rows-layout
        ``step`` and cached: the hub fractions that size its static
        budget of scattered reads (``suggest_hub_cap``)."""
        meta = self._bucket_meta.get(step)
        if meta is None:
            from ..ops.sample import exact_bucket_meta
            meta = exact_bucket_meta(self._indptr, step=step)
            self._bucket_meta[step] = meta
        return meta

    def __repr__(self):
        return (f"CSRTopo(node_count={self.node_count}, "
                f"edge_count={self.edge_count}, device={self.device}, "
                f"indptr_dtype={self._indptr.dtype}, "
                f"indices_dtype={self._indices.dtype})")
