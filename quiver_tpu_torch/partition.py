"""Disk-tier artifacts (the cold-tier part of ``quiver_tpu/partition.py``).

The disk tier of the feature store is one mmap-able rows file, its
resident int8 sidecars and the storage-row -> file-row map, which is
what ``Feature.set_mmap_file`` takes::

    result_path/disk_rows.npy                   (the rows, mmap-able)
    result_path/disk_scale.npy, disk_zero.npy   (int8 policy only)
    result_path/disk_map.npy                    (storage row -> file row)
    result_path/dtype_meta.json

The format is the JAX package's, byte for byte: each package reads the
other's artifact. int8 rows are quantized by ``ops.quant.quantize``, the
JAX package's per-row affine code with the same float32 arithmetic, so
the two write the same codes and sidecars.

The probability-driven partitioner and the partition-placement artifacts
of the JAX module belong to the multi-GPU slice (ROADMAP Queue 1 item 7)
and are not here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .ops import quant

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
