"""The port's placement metadata and partition artifacts
(``PartitionInfo``, ``ExchangeCapPlan`` in ``quiver_tpu_torch/feature.py``,
the partitioner and artifacts of ``quiver_tpu_torch/partition.py``)
against the JAX package's, exactly: the maps, the cap plans and the
dispatch equal, the partitioner's assignment equal, and every artifact
file byte for byte (an ``.npz``'s members, whose zip headers carry the
time of writing) with each package reading the other's. The lookups
through a ``DistFeature`` are in ``test_torch_comm.py``."""

import json
import os
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu import partition as jpart
from quiver_tpu_torch import (DistFeature, PartitionInfo, TorchComm,
                              partition)
from quiver_tpu_torch.ops import quant

N = 240


def _info_pair(g2h, hosts, host, rep):
    return (PartitionInfo(host=host, hosts=hosts, global2host=g2h,
                          replicate=rep),
            qv.PartitionInfo(host=host, hosts=hosts, global2host=g2h,
                             replicate=rep))


@pytest.mark.parametrize("rep", [None, np.array([3, 77, 140], np.int32)])
@pytest.mark.parametrize("hosts,host", [(2, 1), (4, 0), (4, 3)])
def test_partition_info_equals_jax(hosts, host, rep):
    rng = np.random.default_rng(hosts + host)
    g2h = rng.integers(0, hosts, N).astype(np.int32)
    ours, theirs = _info_pair(g2h, hosts, host, rep)
    assert ours.node_count == theirs.node_count == N
    assert ours.local_sizes == theirs.local_sizes
    for a, b in ((ours.global2host, theirs.global2host),
                 (ours.global2local, theirs.global2local)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = rng.integers(0, N, 50)
    for a, b in zip(ours.dispatch(torch.from_numpy(ids)),
                    theirs.dispatch(ids)):
        assert len(a) == len(b) == hosts
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("degree", [False, True])
@pytest.mark.parametrize("frontier,dup", [(64, 8.0), (1_081_344, 1.0),
                                          (4096, 3.5), (10, 100.0)])
def test_plan_exchange_cap_equals_jax(frontier, dup, degree):
    rng = np.random.default_rng(7)
    g2h = (rng.random(N) < 0.7).astype(np.int32)   # a skewed 2-way split
    deg = rng.integers(0, 50, N) if degree else None
    ours, theirs = _info_pair(g2h, 2, 0, None)
    a = ours.plan_exchange_cap(frontier, None if deg is None
                               else torch.from_numpy(deg), dup_factor=dup)
    b = theirs.plan_exchange_cap(frontier, deg, dup_factor=dup)
    assert tuple(a) == tuple(b)
    assert a._fields == b._fields


def test_from_partition_refuses_and_defaults():
    """``from_partition`` wants a comm with a group, and its device is
    the card unless asked for the CPU (no card here: it raises)."""
    info = PartitionInfo(hosts=1, global2host=np.zeros(4, np.int32))
    feat = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="process group"):
        DistFeature.from_partition(feat, info, TorchComm(0, 1))
    with pytest.raises(ValueError, match="merge_counters"):
        DistFeature(None, info, TorchComm(0, 1), merge_counters=True)


# -- the partitioner ----------------------------------------------------------


def _probs(rng, p, n=3000):
    return [rng.random(n) ** (i + 1) for i in range(p)]


@pytest.mark.parametrize("p,chunk", [(2, 256), (3, 16), (4, 7)])
def test_partitioner_equals_jax(p, chunk):
    probs = _probs(np.random.default_rng(p), p)
    ours, op = partition.partition_feature_without_replication(
        [torch.from_numpy(x) for x in probs], chunk)
    theirs, tp = jpart.partition_feature_without_replication(probs, chunk)
    assert len(ours) == len(theirs) == p
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(np.sort(np.concatenate(ours)), np.arange(3000))
    for a, b in zip(op, tp):
        np.testing.assert_array_equal(a, b)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _same_npz(a, b):
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        names = sorted(za.namelist())
        return names == sorted(zb.namelist()) and all(
            za.read(n) == zb.read(n) for n in names)


def test_partition_folder_byte_identical(tmp_path):
    probs = _probs(np.random.default_rng(1), 3)
    ours = partition.quiver_partition_feature(
        probs, str(tmp_path / "port"), cache_memory_budget="48K",
        per_feature_size=400, chunk_size=64)
    theirs = jpart.quiver_partition_feature(
        probs, str(tmp_path / "jax"), cache_memory_budget="48K",
        per_feature_size=400, chunk_size=64)
    np.testing.assert_array_equal(ours[0], theirs[0])
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 7
    for f in files:
        assert _same_bytes(tmp_path / "port" / f, tmp_path / "jax" / f), f
    for i in range(3):
        for a, b in zip(partition.load_quiver_feature_partition(
                            i, str(tmp_path / "jax")),
                        jpart.load_quiver_feature_partition(
                            i, str(tmp_path / "port"))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileExistsError):
        partition.quiver_partition_feature(probs, str(tmp_path / "port"))
    partition.quiver_partition_feature(probs, str(tmp_path / "port"),
                                       overwrite=True)


@pytest.mark.parametrize("policy", [None, "fp16", "bf16", "int8"])
def test_quantized_partitions_byte_identical(tmp_path, policy):
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((300, 20)).astype(np.float32)
    parts = [np.sort(rng.choice(300, 100, replace=False)) for _ in range(2)]
    partition.save_quantized_feature_partition(
        torch.from_numpy(feat), [torch.from_numpy(p) for p in parts],
        str(tmp_path / "port"), dtype_policy=policy)
    jpart.save_quantized_feature_partition(feat, parts, str(tmp_path / "jax"),
                                           dtype_policy=policy)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    for f in files:
        assert _same_bytes(tmp_path / "port" / f, tmp_path / "jax" / f), f
    for i in range(2):
        ours, meta = partition.load_quantized_feature_partition(
            i, str(tmp_path / "jax"), mmap=(i == 1))
        theirs, jmeta = jpart.load_quantized_feature_partition(
            i, str(tmp_path / "port"))
        assert meta == jmeta
        for a, b in zip(quant.tier_parts(ours),
                        (theirs.data, theirs.scale, theirs.zero)
                        if policy == "int8" else (theirs,)):
            if a is None:
                continue
            b = np.asarray(b)
            if b.dtype == ml_dtypes.bfloat16:
                assert a.dtype == torch.bfloat16
                a, b = a.view(torch.int16).numpy(), b.view(np.int16)
            np.testing.assert_array_equal(a.numpy() if torch.is_tensor(a)
                                          else a, b)
    with pytest.raises(FileExistsError):
        partition.save_quantized_feature_partition(
            feat, parts, str(tmp_path / "port"), dtype_policy=policy)


@pytest.mark.parametrize("rep", [None, np.array([5, 9], np.int32)])
def test_partition_info_artifact(tmp_path, rep):
    g2h = np.random.default_rng(3).integers(0, 4, N).astype(np.int32)
    ours, theirs = _info_pair(g2h, 4, 2, rep)
    mo = partition.save_partition_info(ours, str(tmp_path / "port"))
    mj = jpart.save_partition_info(theirs, str(tmp_path / "jax"))
    assert mo == mj
    assert _same_bytes(tmp_path / "port" / "partition_info.json",
                       tmp_path / "jax" / "partition_info.json")
    assert _same_npz(tmp_path / "port" / "partition_info.npz",
                     tmp_path / "jax" / "partition_info.npz")
    back = partition.load_partition_info(str(tmp_path / "jax"), host=1)
    again = jpart.load_partition_info(str(tmp_path / "port"), host=1)
    assert back.host == again.host == 1 and back.hosts == 4
    np.testing.assert_array_equal(back.global2local.numpy(),
                                  np.asarray(again.global2local))
    with pytest.raises(FileExistsError):
        partition.save_partition_info(ours, str(tmp_path / "port"))
    with open(tmp_path / "port" / "partition_info.json", "w") as fh:
        json.dump({"kind": "disk_tier"}, fh)
    with pytest.raises(ValueError, match="not a partition_info"):
        partition.load_partition_info(str(tmp_path / "port"))
    meta = dict(mo, hosts=2)
    with open(tmp_path / "port" / "partition_info.json", "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(ValueError, match="mis-decode"):
        partition.load_partition_info(str(tmp_path / "port"))


@pytest.mark.parametrize("hot", [0, 7, [3, 40, 0, 100]])
def test_hot_mask_and_locality_table_equal_jax(hot):
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 12, N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    g2h = rng.integers(0, 4, N).astype(np.int32)
    g2h[:4] = np.arange(4)
    np.testing.assert_array_equal(
        partition.partition_hot_mask(torch.from_numpy(g2h), hot, deg),
        jpart.partition_hot_mask(g2h, hot, deg))
    for kw in ({}, {"degree": deg * 2, "include_self": False}):
        ours = partition.build_locality_table(
            torch.from_numpy(indptr), torch.from_numpy(indices), g2h, hot,
            **kw)
        theirs = jpart.build_locality_table(indptr, indices, g2h, hot, **kw)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_port_imports_no_jax_for_partitioning():
    """The jax-free modules the partition path uses stay jax-free."""
    import subprocess
    import sys
    code = ("import sys, quiver_tpu_torch.partition, quiver_tpu_torch.comm,"
            " quiver_tpu_torch.parallel.dist, chip_smoke"
            "\nprint([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'quiver_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
