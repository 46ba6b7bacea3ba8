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

``generate_synthetic_cold_dataset`` writes the JAX package's synthetic
papers100M-shaped dataset whose feature rows live on disk (a disk-tier
artifact, ``partition.save_disk_tier``), the same graph, labels and
codes from the same seed; ``load_synthetic_cold_dataset`` rebuilds it as
a topology and a disk-tier ``Feature``.
"""

from __future__ import annotations

import json
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


# -- synthetic bigger-than-RAM (papers100M-shaped) generator ----------------
# The disk tier needs a graph whose feature rows need not fit in RAM: power-
# law degrees sorted descending (identity storage order is the hot order, no
# permutation needed), skewed neighbour popularity (frontiers hit hot rows
# more than uniformly, as degree-proportional access does), and the feature
# rows streamed in chunks into a quantized disk-tier artifact, so that the
# full-width matrix is never made.

_COLD_META = "meta.json"


def generate_synthetic_cold_dataset(out_dir: str, nodes: int = 1_000_000,
                                    dim: int = 128, avg_deg: int = 15,
                                    hot_frac: float = 0.05,
                                    dtype_policy: str = "int8",
                                    skew: float = 2.0, classes: int = 64,
                                    seed: int = 0,
                                    chunk_rows: int = 1 << 17,
                                    overwrite: bool = False) -> dict:
    """Write the synthetic papers100M-shaped dataset of the JAX package
    (``quiver_tpu/datasets.py``) whose feature rows live on disk::

        out_dir/indptr.npy, indices.npy     (CSR; degrees descending)
        out_dir/labels.npy
        out_dir/hot_rows.npy                (first ceil(hot_frac * N)
                                             rows, decoded: the hot tier)
        out_dir/disk/...                    (save_disk_tier artifact of
                                             all N rows; identity map)
        out_dir/meta.json

    Neighbour ids draw as ``floor(N * u**skew)``, dense on the low
    (high-degree, hot) ids, so sampled frontiers show a realistic hot-tier
    hit rate. The same seed gives the JAX package's files: the graph,
    labels and artifact byte for byte; ``hot_rows.npy`` decoded by this
    package's convention (``quant.decode_np``: the multiply rounded, then
    the add), where JAX rounds once through float64, so a few of its
    values may differ from JAX's file by one rounding. Returns the meta
    dict."""
    from .ops import quant
    from .partition import save_disk_tier

    if not 0.0 < hot_frac <= 1.0:
        raise ValueError(f"hot_frac must be in (0, 1], got {hot_frac}")
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, _COLD_META)
    if os.path.exists(meta_path) and not overwrite:
        raise FileExistsError(
            f"{meta_path} exists; pass overwrite=True to replace it")
    rng = np.random.default_rng(seed)

    # graph: lognormal degrees sorted descending (storage order = hot
    # order), neighbour popularity by the same ordering through u**skew
    deg = np.clip(np.exp(rng.normal(np.log(max(avg_deg, 1)), 1.0,
                                    nodes)), 0, 50_000).astype(np.int64)
    deg[::-1].sort()                     # descending, in place
    indptr = np.zeros(nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = np.lib.format.open_memmap(
        os.path.join(out_dir, "indices.npy"), mode="w+", dtype=np.int32,
        shape=(e,))

    def draw_edges(r, k):
        return np.minimum((nodes * r.random(k) ** skew),
                          nodes - 1).astype(np.int32)

    edge_chunk = max(chunk_rows * max(avg_deg, 1), 1 << 20)
    for lo in range(0, e, edge_chunk):
        hi = min(lo + edge_chunk, e)
        indices[lo:hi] = _gen_block(seed + 1, lo, hi, e, (), draw_edges)
    indices.flush()
    del indices
    np.save(os.path.join(out_dir, "indptr.npy"), indptr)
    np.save(os.path.join(out_dir, "labels.npy"),
            rng.integers(0, classes, nodes).astype(np.int32))

    def read_chunk(lo, hi):
        return _gen_block(
            seed + 2, lo, hi, nodes, (dim,),
            lambda r, k: r.standard_normal((k, dim)).astype(np.float32))

    disk_dir = os.path.join(out_dir, "disk")
    tier_meta = save_disk_tier((read_chunk, nodes, dim),
                               np.arange(nodes, dtype=np.int64),
                               disk_dir, dtype_policy=dtype_policy,
                               overwrite=overwrite,
                               chunk_rows=chunk_rows)

    # the hot tier: the first rows of the artifact, decoded (chunked)
    hot_rows = max(int(np.ceil(nodes * hot_frac)), 1)
    mm = np.load(os.path.join(disk_dir, "disk_rows.npy"), mmap_mode="r")
    sides = None
    if tier_meta["dtype_policy"] == "int8":
        sides = [np.load(os.path.join(disk_dir, f"disk_{k}.npy"))
                 for k in ("scale", "zero")]
    hot = np.lib.format.open_memmap(
        os.path.join(out_dir, "hot_rows.npy"), mode="w+",
        dtype=np.dtype(tier_meta["logical_dtype"]), shape=(hot_rows, dim))
    for lo in range(0, hot_rows, chunk_rows):
        hi = min(lo + chunk_rows, hot_rows)
        rows = np.asarray(mm[lo:hi])
        hot[lo:hi] = rows if sides is None else quant.decode_np(
            rows, sides[0][lo:hi], sides[1][lo:hi])
    hot.flush()
    del mm, hot

    meta = {"kind": "synthetic_cold", "nodes": nodes, "dim": dim,
            "edges": e, "avg_deg": avg_deg, "hot_rows": hot_rows,
            "hot_frac": hot_frac, "skew": skew, "classes": classes,
            "seed": seed, "dtype_policy": tier_meta["dtype_policy"]}
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    return meta


def load_synthetic_cold_dataset(out_dir: str,
                                prefetch_rows: Optional[int] = None,
                                depth: int = 2,
                                decode_staged: bool = True,
                                device=None, **prefetch_kwargs):
    """Rebuild a generated dataset: ``(csr_topo, feature, meta)``, on
    ``device`` (the card unless ``"cpu"``). The ``Feature`` holds
    ``hot_rows.npy`` in its hot tier and every row on its disk tier;
    ``prefetch_rows`` attaches the cold prefetcher with that ring
    capacity, ``depth`` and ``decode_staged``, and ``prefetch_kwargs``
    go to ``enable_cold_prefetch`` (``workers``, ``io_qd``, ...). The
    caller owns ``feature.close()``."""
    from .feature import DeviceConfig, Feature
    from .partition import load_disk_tier

    with open(os.path.join(out_dir, _COLD_META)) as fh:
        meta = json.load(fh)
    topo = CSRTopo(indptr=np.load(os.path.join(out_dir, "indptr.npy")),
                   indices=np.load(os.path.join(out_dir, "indices.npy")),
                   device=device)
    store = Feature(device=device)
    store.from_mmap(None, DeviceConfig(
        [np.load(os.path.join(out_dir, "hot_rows.npy"))], None))
    kwargs, _ = load_disk_tier(os.path.join(out_dir, "disk"))
    store.set_mmap_file(**kwargs)
    if prefetch_rows:
        store.enable_cold_prefetch(prefetch_rows, depth=depth,
                                   decode_staged=decode_staged,
                                   **prefetch_kwargs)
    return topo, store, meta


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
