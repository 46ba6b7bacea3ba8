"""Datasets (counterpart of ``quiver_tpu/datasets.py``): a user's
OGB-style numpy dump loaded into the port's structures, and the seeded
drifting node-id trace.

A user with a real dataset (ogbn-products, Reddit, ...) exports it once
with numpy on any machine that has it:

    import numpy as np
    from ogb.nodeproppred import PygNodePropPredDataset
    ds = PygNodePropPredDataset("ogbn-products", root=...)
    data, split = ds[0], ds.get_idx_split()
    np.savez("products.npz",
             edge_index=data.edge_index.numpy(),
             feat=data.x.numpy(),
             labels=data.y.numpy().squeeze(),
             train_idx=split["train"].numpy(),
             valid_idx=split["valid"].numpy(),
             test_idx=split["test"].numpy())

then loads here as ``from_numpy_dir("products.npz")`` (a directory of
per-key ``.npy`` files with the same names works too) into ``CSRTopo``,
ready for ``Feature`` and the train steps. The file format is the JAX
package's, and both packages load the same dump to the same topology,
features, labels and splits.

The synthetic cold-tier dataset of the JAX package
(``generate_synthetic_cold_dataset``) waits for the port's disk tier.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np

from .debug import log as _log
from .utils import CSRTopo

#: required keys and their expected rank
_REQUIRED = {"edge_index": 2, "feat": 2, "labels": 1, "train_idx": 1}
_OPTIONAL = {"valid_idx": 1, "test_idx": 1}


class GraphDataset(NamedTuple):
    """A loaded node-classification dataset, framework-native.

    ``csr_topo`` is ready for any sampler; ``feat``/``labels`` are host
    numpy (hand ``feat`` to ``Feature`` with whatever cache policy fits
    the machine); ``*_idx`` are the official splits (``valid_idx`` and
    ``test_idx`` may be None).
    """

    csr_topo: CSRTopo
    feat: np.ndarray
    labels: np.ndarray
    train_idx: np.ndarray
    valid_idx: Optional[np.ndarray]
    test_idx: Optional[np.ndarray]

    @property
    def num_classes(self) -> int:
        # papers100M-style dumps store float labels with NaN on
        # unlabeled nodes; classes count over the labeled ones
        finite = self.labels[np.isfinite(
            self.labels.astype(np.float64, copy=False))]
        if finite.size == 0:
            raise ValueError("labels contain no finite entries")
        return int(finite.max()) + 1


def _load_mapping(path: str) -> dict:
    """Accept either a ``.npz`` bundle or a directory of ``.npy`` files
    named after the keys."""
    if os.path.isfile(path):
        return dict(np.load(path))
    if os.path.isdir(path):
        out = {}
        for key in {**_REQUIRED, **_OPTIONAL}:
            f = os.path.join(path, key + ".npy")
            if os.path.exists(f):
                out[key] = np.load(f)
        return out
    raise FileNotFoundError(
        f"{path!r} is neither an .npz file nor a directory of .npy files")


def from_numpy_dir(path: str, undirected: bool = False,
                   device=None) -> GraphDataset:
    """Load an OGB-style numpy dump (see module docstring for the
    one-liner that produces it) into ``GraphDataset``.

    Required keys: ``edge_index`` [2, E] int, ``feat`` [N, dim],
    ``labels`` [N] (an [N, 1] column is squeezed), ``train_idx``.
    Optional: ``valid_idx``, ``test_idx``. ``undirected=True`` adds the
    reverse of every edge (OGB products/Reddit dumps are already
    symmetric; set it for directed dumps when the model expects
    symmetric message passing). The topology lies on ``device`` (the
    card unless ``"cpu"``).
    """
    data = _load_mapping(path)
    missing = [k for k in _REQUIRED if k not in data]
    if missing:
        raise KeyError(
            f"dataset at {path!r} is missing key(s) {missing}; expected "
            f"{sorted(_REQUIRED)} (+ optional {sorted(_OPTIONAL)})")

    labels = np.asarray(data["labels"])
    if labels.ndim == 2 and labels.shape[1] == 1:
        labels = labels[:, 0]
    # some exports mark unlabeled nodes with an integer -1 instead of
    # NaN; -1 passes isfinite and would flow into the loss as a real
    # class. Normalize negative sentinels to the NaN convention (loudly
    # — the dtype widens to float) so num_classes and eval masks see
    # them as unlabeled.
    finite = np.isfinite(labels.astype(np.float64, copy=False))
    if bool((labels[finite] < 0).any()):
        neg = int((labels[finite] < 0).sum())
        _log("labels contain %d negative entries; treating them as "
             "unlabeled (NaN convention, papers100M-style)", neg)
        labels = labels.astype(np.float32)
        labels[labels < 0] = np.nan
    feat = np.ascontiguousarray(data["feat"])
    for key, rank in {**_REQUIRED, **_OPTIONAL}.items():
        if key in data and key != "labels" and np.asarray(data[key]).ndim != rank:
            raise ValueError(
                f"{key} must be rank {rank}, got shape "
                f"{np.asarray(data[key]).shape}")
    if labels.ndim != 1:
        raise ValueError(f"labels must be [N] or [N, 1], got {labels.shape}")

    edge_index = np.asarray(data["edge_index"])
    if edge_index.shape[0] != 2:
        raise ValueError(
            f"edge_index must be [2, E], got {edge_index.shape}")
    n = feat.shape[0]
    if labels.shape[0] != n:
        raise ValueError(
            f"feat has {n} rows but labels has {labels.shape[0]}")
    if edge_index.size and int(edge_index.max()) >= n:
        raise ValueError(
            f"edge_index references node {int(edge_index.max())} but "
            f"feat only has {n} rows")
    if edge_index.size and int(edge_index.min()) < 0:
        # a -1 sentinel would silently wrap to node n-1 in the CSR build
        raise ValueError(
            f"edge_index contains negative node id "
            f"{int(edge_index.min())}")
    if undirected:
        edge_index = np.concatenate(
            [edge_index, edge_index[::-1]], axis=1)

    def _idx(key):
        if key not in data:
            return None
        idx = np.asarray(data[key]).astype(np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{key} out of range [0, {n})")
        return idx

    topo = CSRTopo(edge_index=edge_index, node_count=n, device=device)
    return GraphDataset(csr_topo=topo, feat=feat, labels=labels,
                        train_idx=_idx("train_idx"),
                        valid_idx=_idx("valid_idx"),
                        test_idx=_idx("test_idx"))


#: generation block (rows, edges, trace positions): content is made per
#: fixed block keyed by (seed, block start), so the slicing a caller asks
#: for cannot change it
_GEN_BLOCK = 8192


def _gen_block(seed: int, lo: int, hi: int, total: int, shape_tail, fn):
    """Values [lo, hi) assembled from fixed ``_GEN_BLOCK``-sized
    deterministic blocks of the [0, total) stream: ``fn(rng, count)``
    draws one block's worth. Block boundaries depend only on ``total``,
    never on the requested [lo, hi) — chunk-size invariant."""
    out = None
    b = (lo // _GEN_BLOCK) * _GEN_BLOCK
    while b < hi:
        be = min(b + _GEN_BLOCK, total)
        block = fn(np.random.default_rng([seed, b]), be - b)
        s, e = max(lo, b), min(hi, be)
        if out is None:
            out = np.empty((hi - lo,) + tuple(shape_tail), block.dtype)
        out[s - lo:e - lo] = block[s - b:e - b]
        b = be
    return out


def generate_drifting_trace(length: int, nodes: int,
                            skew: float = 2.0,
                            rotate_every: int = 1 << 14,
                            stride: Optional[int] = None,
                            hot_frac: float = 0.05,
                            seed: int = 0, lo: int = 0,
                            hi: Optional[int] = None) -> np.ndarray:
    """A seeded node-id trace whose power-law HOT SET rotates on a
    schedule: the input on which adaptive caching (hot-set rotation,
    ``Feature.rotate_hot_set``) must win and static placement lose.

    Each position draws a popularity RANK ``floor(nodes * u**skew)``
    (density concentrated on low ranks), then the
    rank maps to a node id shifted by the position's drift phase::

        phase = index // rotate_every
        id    = (rank + phase * stride) % nodes

    so inside one phase the trace is a stationary power-law over a
    contiguous hot set, and every ``rotate_every`` positions the
    WHOLE popularity ordering shifts by ``stride`` ids (default: the
    hot-set width, ``ceil(nodes * hot_frac)`` — each drift lands the
    new hot set entirely outside the old one). The first phase
    (indices ``[0, rotate_every)``) is the STATIONARY PREFIX the A/B
    protocol scores "no worse than static" on.

    Chunk-invariant: ranks come from fixed
    ``_GEN_BLOCK``-sized blocks keyed ``(seed, block_start)`` and the
    phase depends only on the ABSOLUTE index, so any ``[lo, hi)``
    slicing assembles the identical trace. The trace is the JAX
    package's, bit for bit. Returns int64 ids in ``[0, nodes)``."""
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    if rotate_every < 1:
        raise ValueError(
            f"rotate_every must be >= 1, got {rotate_every}")
    if stride is None:
        stride = max(1, int(math.ceil(nodes * float(hot_frac))))
    hi = length if hi is None else hi
    if not 0 <= lo <= hi <= length:
        raise ValueError(f"need 0 <= lo <= hi <= length, got "
                         f"[{lo}, {hi}) of {length}")
    if hi == lo:
        return np.empty((0,), np.int64)
    ranks = _gen_block(
        seed, lo, hi, length, (),
        lambda r, k: np.minimum((nodes * r.random(k) ** skew),
                                nodes - 1).astype(np.int64))
    phase = np.arange(lo, hi, dtype=np.int64) // int(rotate_every)
    return (ranks + phase * int(stride)) % int(nodes)
