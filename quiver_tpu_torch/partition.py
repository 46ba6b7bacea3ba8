"""Partitioning and placement artifacts (counterpart of
``quiver_tpu/partition.py``).

- The probability-driven partitioner (reference partition.py:14-173):
  chunk-round-robin greedy assignment, each partition taking its
  top-scoring nodes with score = own_prob * P - sum(other_probs), no
  replication, in numpy (offline preprocessing; the probabilities come
  from ``ops.sample.sample_prob``), and its result folder and loader.
- Quantized feature partitions: each partition's rows stored under a
  dtype policy, with ``dtype_meta.json``.
- The disk tier of the feature store: one mmap-able rows file, its
  resident int8 sidecars and the storage-row -> file-row map, which is
  what ``Feature.set_mmap_file`` takes::

    result_path/disk_rows.npy                   (the rows, mmap-able)
    result_path/disk_scale.npy, disk_zero.npy   (int8 policy only)
    result_path/disk_map.npy                    (storage row -> file row)
    result_path/dtype_meta.json

- Placement artifacts (``save_partition_info``), each partition's hot
  set and the locality table of the partition-aware router.

Every format is the JAX package's, byte for byte: each package reads the
other's artifacts. int8 rows are quantized by ``ops.quant.quantize``, the
JAX package's per-row affine code with the same float32 arithmetic, so
the two write the same codes and sidecars. The partitioner never prompts
(the reference calls ``input()``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Sequence

import numpy as np
import torch

from .ops import quant
from .utils.sizes import parse_size

QUIVER_MAGIC_NUMBER = 256

_DTYPE_META = "dtype_meta.json"


def save_disk_tier(feat_rows, disk_map, result_path: str,
                   dtype_policy="int8", overwrite: bool = False,
                   chunk_rows: int = 1 << 18):
    """Write a disk-tier artifact (the layout in the module doc).

    ``feat_rows`` is the file rows' content: an ``[n, dim]`` array (or
    tensor), or, for data larger than memory, ``(chunk_reader, n, dim)``
    where ``chunk_reader(lo, hi)`` returns rows ``[lo, hi)``; either way
    the rows go through quantization ``chunk_rows`` at a time into an
    ``open_memmap``, so the full-width array is never made. ``disk_map``
    spans the full logical id space (entries below a store's
    ``cache_rows`` are never read). Policies: ``None``/"fp32", "fp16",
    "int8" ("bf16" is refused: ``np.load(mmap_mode="r")`` cannot rebuild
    the dtype). Returns the meta dict written to ``dtype_meta.json``;
    ``load_disk_tier(result_path)`` gives back ``set_mmap_file``'s
    arguments."""
    policy = quant.resolve_policy(dtype_policy)
    if policy == "bf16":
        raise ValueError("bf16 disk tiers are not mmap-loadable "
                         "(np.load cannot rebuild the dtype); use "
                         "fp16 or int8")
    if isinstance(feat_rows, tuple):
        reader, rows, dim = feat_rows
        rows, dim = int(rows), int(dim)
    else:
        feat_rows = _numpy(feat_rows)
        reader = lambda lo, hi: feat_rows[lo:hi]   # noqa: E731
        rows, dim = feat_rows.shape
    os.makedirs(result_path, exist_ok=True)
    rows_path = os.path.join(result_path, "disk_rows.npy")
    if os.path.exists(rows_path) and not overwrite:
        raise FileExistsError(
            f"{rows_path} exists; pass overwrite=True to replace it")
    probe = _numpy(reader(0, min(1, rows)))
    logical_dtype = probe.dtype
    storage_dtype = {None: logical_dtype, "fp16": np.dtype(np.float16),
                     "int8": np.dtype(np.int8)}[policy]
    out = np.lib.format.open_memmap(rows_path, mode="w+",
                                    dtype=storage_dtype,
                                    shape=(rows, dim))
    scale = zero = None
    if policy == "int8":
        scale = np.lib.format.open_memmap(
            os.path.join(result_path, "disk_scale.npy"), mode="w+",
            dtype=logical_dtype, shape=(rows, 1))
        zero = np.lib.format.open_memmap(
            os.path.join(result_path, "disk_zero.npy"), mode="w+",
            dtype=logical_dtype, shape=(rows, 1))
    for lo in range(0, rows, chunk_rows):
        hi = min(lo + chunk_rows, rows)
        q = quant.quantize(_numpy(reader(lo, hi)), policy)
        if quant.is_quantized(q):
            out[lo:hi] = q.data.numpy()
            scale[lo:hi] = q.scale.numpy()
            zero[lo:hi] = q.zero.numpy()
        else:
            out[lo:hi] = _numpy(q)
    out.flush()
    if scale is not None:
        scale.flush()
        zero.flush()
    disk_map = _numpy(disk_map)
    np.save(os.path.join(result_path, "disk_map.npy"), disk_map)
    meta = {"kind": "disk_tier", "dtype_policy": policy or "fp32",
            "logical_dtype": str(logical_dtype),
            "storage_dtype": str(storage_dtype),
            "rows": rows, "dim": dim,
            "map_rows": int(disk_map.shape[0])}
    with open(os.path.join(result_path, _DTYPE_META), "w") as fh:
        json.dump(meta, fh)
    return meta


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def load_disk_tier(result_path: str):
    """Load a :func:`save_disk_tier` artifact: ``(kwargs, meta)``, where
    ``Feature.set_mmap_file(**kwargs)`` attaches the tier (the rows file
    stays a path, so the store mmaps it; int8 sidecars are paths too and
    load resident). Refuses an artifact whose rows file does not match
    its recorded meta: a mis-described file would be mis-decoded."""
    with open(os.path.join(result_path, _DTYPE_META)) as fh:
        meta = json.load(fh)
    if meta.get("kind") != "disk_tier":
        raise ValueError(
            f"{result_path} holds a {meta.get('kind', 'partition')!r} "
            "artifact, not a disk_tier one")
    rows_path = os.path.join(result_path, "disk_rows.npy")
    arr = np.load(rows_path, mmap_mode="r")
    if str(arr.dtype) != meta["storage_dtype"] or \
            list(arr.shape) != [meta["rows"], meta["dim"]]:
        raise ValueError(
            f"{rows_path} is {arr.shape} {arr.dtype} but its meta "
            f"records [{meta['rows']}, {meta['dim']}] "
            f"{meta['storage_dtype']} — refusing to mis-decode")
    kwargs = {"path": rows_path,
              "disk_map": np.load(os.path.join(result_path,
                                               "disk_map.npy"))}
    if meta["dtype_policy"] == "int8":
        kwargs["scale"] = os.path.join(result_path, "disk_scale.npy")
        kwargs["zero"] = os.path.join(result_path, "disk_zero.npy")
    return kwargs, meta


def load_disk_tier_store(result_path: str, hot_rows: int = 0,
                         prefetch_rows=None, device=None,
                         **prefetch_kwargs):
    """A ``Feature`` over an artifact: its hot tier holds the first
    ``hot_rows`` file rows decoded (so hot and disk lookups give the same
    bits: the quantization error lies in the artifact once, not at the
    tier boundary), its disk tier is the artifact's file; with
    ``prefetch_rows`` the cold prefetcher is attached with that ring
    capacity (``prefetch_kwargs`` go to ``enable_cold_prefetch``). The
    store lives on ``device`` (the card unless ``"cpu"``). Returns
    ``(feature, meta)``; the caller owns ``feature.close()``."""
    from .feature import DeviceConfig, Feature

    kwargs, meta = load_disk_tier(result_path)
    store = Feature(device=device)
    if hot_rows:
        mm = np.load(kwargs["path"], mmap_mode="r")
        rows = np.array(mm[:int(hot_rows)])
        if meta["dtype_policy"] == "int8":
            rows = quant.decode_np(rows,
                                   np.load(kwargs["scale"])[:int(hot_rows)],
                                   np.load(kwargs["zero"])[:int(hot_rows)])
        store.from_mmap(None, DeviceConfig([rows], None))
    store.set_mmap_file(**kwargs)
    if prefetch_rows:
        store.enable_cold_prefetch(prefetch_rows, **prefetch_kwargs)
    return store, meta


# -- the probability-driven partitioner ---------------------------------------


def partition_feature_without_replication(
        probs: Sequence, chunk_size: int = QUIVER_MAGIC_NUMBER):
    """Greedy chunked partitioning (reference partition.py:14-70):
    ``probs[p]`` is partition ``p``'s access probability of every node
    (arrays or tensors). Returns (per-partition id arrays, the
    probabilities as float64 numpy arrays)."""
    probs = [_numpy(p).astype(np.float64) for p in probs]
    p_num = len(probs)
    n = probs[0].shape[0]
    blob = chunk_size * p_num
    res: List[List[np.ndarray]] = [[] for _ in range(p_num)]
    start_partition = 0
    pos = 0
    while pos < n:
        end = min(n, pos + blob)
        size = end - pos
        chunk = np.arange(pos, end)
        # score[i] for partition i: own prob weighted P, minus others'
        stacked = np.stack([p[chunk] for p in probs])       # [P, size]
        total = stacked.sum(axis=0)
        score = stacked * p_num - (total - stacked) + 1e-6  # [P, size]
        assigned = 0
        for off in range(p_num):
            idx = (start_partition + off) % p_num
            take = min(chunk_size, size - assigned)
            if take <= 0:
                break
            order = np.argsort(-score[idx], kind="stable")[:take]
            res[idx].append(chunk[order])
            # -inf, not a finite sentinel: real scores reach -(P - 1)
            score[:, order] = -np.inf
            assigned += take
        start_partition += 1
        pos = end
    out = [np.concatenate(r) if r else np.empty(0, np.int64) for r in res]
    return out, probs


def quiver_partition_feature(probs, result_path: str,
                             cache_memory_budget=0, per_feature_size=0,
                             chunk_size: int = QUIVER_MAGIC_NUMBER,
                             overwrite: bool = False):
    """Partition by access probability and write the result folder
    (reference partition.py:73-143)::

        result_path/feature_partition_{i}/partition_res.npy
        result_path/feature_partition_{i}/cache_res.npy
        result_path/feature_partition_book.npy

    ``cache_res`` holds each partition's ``cache_memory_budget /
    per_feature_size / P`` most probable nodes. Returns ``(partition
    book, per-partition ids, per-partition cache ids)``."""
    if os.path.exists(result_path):
        if not overwrite:
            raise FileExistsError(
                f"{result_path} exists; pass overwrite=True to replace it")
        shutil.rmtree(result_path)
    p_num = len(probs)
    for i in range(p_num):
        os.makedirs(os.path.join(result_path, f"feature_partition_{i}"))
    budget = parse_size(cache_memory_budget)
    per_feature = parse_size(per_feature_size)
    cache_count = int(budget / (per_feature + 1e-6))
    per_partition_cache = cache_count // p_num
    partition_res, np_probs = partition_feature_without_replication(
        probs, chunk_size)
    partition_book = np.zeros(np_probs[0].shape[0], dtype=np.int64)
    cache_res: List = [None] * p_num
    if cache_count > 0:
        for i in range(p_num):
            order = np.argsort(-np_probs[i], kind="stable")
            cache_res[i] = order[:per_partition_cache]
    for i in range(p_num):
        part_dir = os.path.join(result_path, f"feature_partition_{i}")
        partition_book[partition_res[i]] = i
        np.save(os.path.join(part_dir, "partition_res.npy"), partition_res[i])
        np.save(os.path.join(part_dir, "cache_res.npy"),
                cache_res[i] if cache_res[i] is not None
                else np.empty(0, np.int64))
    np.save(os.path.join(result_path, "feature_partition_book.npy"),
            partition_book)
    return partition_book, partition_res, cache_res


def load_quiver_feature_partition(partition_idx: int, result_path: str):
    """Load partition ``partition_idx`` of :func:`quiver_partition_feature`'s
    folder (reference partition.py:146-173): ``(partition book, its ids,
    its cache ids)``, numpy."""
    part_dir = os.path.join(result_path, f"feature_partition_{partition_idx}")
    partition_res = np.load(os.path.join(part_dir, "partition_res.npy"))
    cache_res = np.load(os.path.join(part_dir, "cache_res.npy"))
    partition_book = np.load(
        os.path.join(result_path, "feature_partition_book.npy"))
    return partition_book, partition_res, cache_res


# -- quantized feature partitions --------------------------------------------


def save_quantized_feature_partition(feat, partition_res, result_path: str,
                                     dtype_policy="int8",
                                     overwrite: bool = False):
    """Write each partition's feature rows under a dtype policy, beside
    :func:`quiver_partition_feature`'s layout::

        result_path/feature_partition_{i}/feature_rows.npy
        result_path/feature_partition_{i}/feature_scale.npy  (int8 only)
        result_path/feature_partition_{i}/feature_zero.npy   (int8 only)
        result_path/feature_partition_{i}/dtype_meta.json

    Rows lie in partition-local order (``partition_res[i]``, the
    partitioner's first return). ``dtype_meta.json`` records the policy,
    storage, logical dtype and shape, so a loader refuses a mismatch.
    bf16 rows are written as their uint16 bit patterns, as in JAX."""
    policy = quant.resolve_policy(dtype_policy)
    feat = _numpy(feat)
    for i, ids in enumerate(partition_res):
        ids = _numpy(ids)
        part_dir = os.path.join(result_path, f"feature_partition_{i}")
        os.makedirs(part_dir, exist_ok=True)
        target = os.path.join(part_dir, "feature_rows.npy")
        if os.path.exists(target) and not overwrite:
            raise FileExistsError(
                f"{target} exists; pass overwrite=True to replace it")
        q = quant.quantize(feat[ids], policy)
        meta = {"dtype_policy": policy or "fp32",
                "logical_dtype": str(feat.dtype),
                "rows": int(ids.shape[0]),
                "dim": int(feat.shape[1])}
        if quant.is_quantized(q):
            np.save(target, q.data.numpy())
            np.save(os.path.join(part_dir, "feature_scale.npy"),
                    q.scale.numpy())
            np.save(os.path.join(part_dir, "feature_zero.npy"),
                    q.zero.numpy())
            meta["storage_dtype"] = "int8"
            meta["sidecar_dtype"] = str(q.scale.numpy().dtype)
        elif q.dtype == torch.bfloat16:
            meta["storage_dtype"] = "bfloat16"
            np.save(target, q.contiguous().view(torch.int16).numpy()
                    .view(np.uint16))
        else:
            arr = np.ascontiguousarray(_numpy(q))
            meta["storage_dtype"] = str(arr.dtype)
            np.save(target, arr)
        with open(os.path.join(part_dir, _DTYPE_META), "w") as fh:
            json.dump(meta, fh)


def load_quantized_feature_partition(partition_idx: int, result_path: str,
                                     mmap: bool = False):
    """Load one partition's rows: ``(tier, meta)``, ``tier`` a CPU
    tensor (fp32, bf16, fp16 policies) or a ``quant.QuantizedTensor`` of
    CPU tensors (int8). ``mmap=True`` maps the rows file (read-only
    pages; the sidecars are small and load resident)."""
    part_dir = os.path.join(result_path, f"feature_partition_{partition_idx}")
    with open(os.path.join(part_dir, _DTYPE_META)) as fh:
        meta = json.load(fh)
    rows = np.load(os.path.join(part_dir, "feature_rows.npy"),
                   mmap_mode="r" if mmap else None)
    rows = _tensor(rows)
    if meta["dtype_policy"] != "int8":
        if meta["storage_dtype"] == "bfloat16":
            rows = rows.view(torch.int16).view(torch.bfloat16)
        return rows, meta
    scale = torch.from_numpy(np.load(os.path.join(part_dir,
                                                  "feature_scale.npy")))
    zero = torch.from_numpy(np.load(os.path.join(part_dir,
                                                 "feature_zero.npy")))
    return quant.QuantizedTensor(rows, scale, zero), meta


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor over the same memory; a read-only
    mmap stays read-only (the tensor must not be written)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # non-writable
        return torch.from_numpy(a)


# -- partition-placement artifacts ---------------------------------------------


def save_partition_info(info, result_path: str, overwrite: bool = False):
    """Write a ``feature.PartitionInfo``'s placement::

        result_path/partition_info.npz      (global2host [+ replicate])
        result_path/partition_info.json     (kind, hosts, host, nodes)

    :func:`load_partition_info` reads it back (each replica passing its
    own ``host=``: the placement is host-agnostic, only the replica
    tail's base differs). Returns the meta dict."""
    os.makedirs(result_path, exist_ok=True)
    npz_path = os.path.join(result_path, "partition_info.npz")
    if os.path.exists(npz_path) and not overwrite:
        raise FileExistsError(
            f"{npz_path} exists; pass overwrite=True to replace it")
    g2h = _numpy(info.global2host).astype(np.int32)
    arrays = {"global2host": g2h}
    if info.replicate is not None:
        arrays["replicate"] = _numpy(info.replicate).astype(np.int32)
    np.savez(npz_path, **arrays)
    meta = {"kind": "partition_info", "hosts": int(info.hosts),
            "host": int(info.host), "nodes": int(g2h.shape[0]),
            "has_replicate": info.replicate is not None}
    with open(os.path.join(result_path, "partition_info.json"), "w") as fh:
        json.dump(meta, fh)
    return meta


def load_partition_info(result_path: str, host=None):
    """A ``feature.PartitionInfo`` from :func:`save_partition_info`'s
    artifact (``host`` overrides the recorded one). Refuses an artifact
    whose arrays do not match their recorded meta."""
    from .feature import PartitionInfo

    with open(os.path.join(result_path, "partition_info.json")) as fh:
        meta = json.load(fh)
    if meta.get("kind") != "partition_info":
        raise ValueError(
            f"{result_path} holds a {meta.get('kind', 'partition')!r} "
            "artifact, not a partition_info one")
    npz = np.load(os.path.join(result_path, "partition_info.npz"))
    g2h = npz["global2host"]
    if g2h.shape[0] != meta["nodes"] or \
            (("replicate" in npz.files) != meta["has_replicate"]):
        raise ValueError(
            f"{result_path}/partition_info.npz does not match its meta "
            f"({g2h.shape[0]} nodes vs recorded {meta['nodes']}) — "
            "refusing to mis-decode")
    if int(g2h.max(initial=0)) >= meta["hosts"]:
        raise ValueError(
            f"{result_path}: global2host names host {int(g2h.max())} "
            f"but meta records only {meta['hosts']} hosts — refusing "
            "to mis-decode")
    rep = npz["replicate"] if meta["has_replicate"] else None
    return PartitionInfo(host=int(meta["host"] if host is None else host),
                         hosts=int(meta["hosts"]), global2host=g2h,
                         replicate=rep)


def partition_hot_mask(global2host, hot_rows, degree) -> np.ndarray:
    """Boolean ``[n]`` mask of each partition's hot tier: the top
    ``hot_rows`` nodes by degree within each partition. ``hot_rows`` is
    an int (the same capacity everywhere) or one per partition."""
    g2h = _numpy(global2host)
    deg = _numpy(degree).astype(np.float64)
    hosts = int(g2h.max(initial=0)) + 1
    caps = ([int(hot_rows)] * hosts if np.isscalar(hot_rows)
            else [int(c) for c in hot_rows])
    hot = np.zeros(g2h.shape[0], bool)
    for p in range(hosts):
        owned = np.flatnonzero(g2h == p)
        order = np.argsort(-deg[owned], kind="stable")[:max(caps[p], 0)]
        hot[owned[order]] = True
    return hot


def build_locality_table(indptr, indices, global2host, hot_rows,
                         degree=None, include_self: bool = True):
    """Degree-mass locality table ``[n, hosts]`` (float32) for the
    partition-aware router: ``table[v, p]`` is the share of node ``v``'s
    expected 1-hop frontier degree mass in partition ``p``'s hot tier
    (neighbours weighted by ``degree + 1``; ``include_self`` adds the
    seed's own row). Rows sum to at most 1."""
    indptr = _numpy(indptr).astype(np.int64)
    indices = _numpy(indices)
    g2h = _numpy(global2host)
    n = indptr.shape[0] - 1
    hosts = int(g2h.max(initial=0)) + 1
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64) \
        if degree is None else _numpy(degree).astype(np.float64)
    hot = partition_hot_mask(g2h, hot_rows, deg)
    mass = deg + 1.0
    hot_mass = np.where(hot, mass, 0.0)
    acc = np.zeros((n, hosts), np.float64)
    total = np.zeros(n, np.float64)
    src = np.repeat(np.arange(n), (indptr[1:] - indptr[:-1]))
    dst = indices[:src.shape[0]]
    np.add.at(acc, (src, g2h[dst]), hot_mass[dst])
    np.add.at(total, src, mass[dst])
    if include_self:
        np.add.at(acc, (np.arange(n), g2h), hot_mass)
        total += mass
    table = acc / np.maximum(total, 1e-12)[:, None]
    return table.astype(np.float32)
