"""Multi-host partitioned features through the public DistFeature API.

The port's counterpart of the JAX package's
``examples/dist_feature_demo.py`` (the reference's multi-node path:
PartitionInfo/DistFeature + NcclComm exchange, feature.py:461-567 +
comm.py:127-182), over the ranks of a ``torch.distributed`` group:
``torchrun``'s, else one rank per visible card (NCCL), or two gloo
ranks with ``--device cpu``.

Every rank holds a shard of the feature rows (probability-partitioned);
each rank samples a frontier and looks its rows up with ``dist[ids]`` —
dispatch, the ``all_to_all`` exchange and the scatter. Verified against
the unpartitioned ground truth; rank 0 prints.

Usage: python -m quiver_tpu_torch.examples.dist_feature_demo
       [--device cuda|cpu]
       torchrun --nproc-per-node 4 -m quiver_tpu_torch.examples.dist_feature_demo
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks

CAP = 8192                       # per-rank frontier budget (-1 padded)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    _ranks.add_device_flag(p)
    return p


def make_data(rng):
    """The demo's graph and features, numpy: ``(n, dim, indptr,
    indices, feat, train_idx)``."""
    n, dim = 20000, 64
    deg = rng.integers(2, 20, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    feat = rng.standard_normal((n, dim)).astype(np.float32)
    train_idx = rng.choice(n, n // 10, replace=False)
    return n, dim, indptr, indices, feat, train_idx


def partition(indptr, indices, train_idx, sizes, n, world, rank, dev):
    """The probability-driven partition (reference partition.py:14-70)
    over ``world`` ranks, as this rank's ``PartitionInfo``."""
    import torch

    from ..feature import PartitionInfo
    from ..ops import sample_prob
    from ..partition import partition_feature_without_replication
    probs = sample_prob(torch.as_tensor(indptr).to(dev),
                        torch.as_tensor(indices).to(dev),
                        torch.as_tensor(train_idx).to(dev), sizes, n)
    parts, _ = partition_feature_without_replication(
        [probs.cpu().numpy()] * world, chunk_size=256)
    global2host = np.zeros(n, np.int32)
    for h, part in enumerate(parts):
        global2host[np.asarray(part)] = h
    return PartitionInfo(host=rank, hosts=world, global2host=global2host)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return _ranks.run(demo, args)


def demo(args, rank, world, group, dev) -> int:
    import torch
    import torch.distributed as dist

    from ..comm import TorchComm
    from ..feature import DistFeature
    from ..ops import sample_multihop

    say = print if rank == 0 else _ranks.quiet
    say(f"mesh: {world} hosts ({dev.type})")

    # ---- graph + features --------------------------------------------------
    rng = np.random.default_rng(0)
    n, dim, indptr, indices, feat, train_idx = make_data(rng)

    # ---- probability-driven partition --------------------------------------
    info = partition(indptr, indices, train_idx, [15, 10], n, world, rank,
                     dev)

    # ---- the public API: from_partition builds this rank's shard -----------
    comm = TorchComm(rank=rank, world_size=world, group=group)
    dist_feat = DistFeature.from_partition(feat, info, comm, device=dev)

    # ---- each rank samples a frontier; one lookup per rank serves it -------
    indptr_t = torch.as_tensor(indptr).to(dev)
    indices_t = torch.as_tensor(indices).to(dev)
    batch_ids = np.full((world, CAP), -1, np.int32)
    for h in range(world):
        # every rank draws every rank's seeds, so the numpy stream is one
        seeds = torch.as_tensor(
            rng.choice(n, 256, replace=False).astype(np.int32))
        if h != rank:
            continue
        n_id, _ = sample_multihop(indptr_t, indices_t, seeds.to(dev),
                                  [10, 5],
                                  torch.Generator(device=dev).manual_seed(h))
        ids = n_id.cpu().numpy()
        ids = ids[ids >= 0]
        batch_ids[h, :min(ids.size, CAP)] = ids[:CAP]
    my_ids = torch.as_tensor(batch_ids[rank]).to(dev)

    # warm-up, then timed run of dist[ids] — dispatch + exchange + scatter
    dist_feat[my_ids]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group)
    t0 = time.time()
    out = dist_feat[my_ids].cpu().numpy()
    dt = time.time() - t0

    # ---- verify against ground truth --------------------------------------
    valid = batch_ids[rank] >= 0
    np.testing.assert_allclose(out[valid], feat[batch_ids[rank][valid]],
                               rtol=1e-6)
    np.testing.assert_array_equal(out[~valid], 0)
    checked = torch.tensor([int(valid.sum())], device=dev)
    slowest = torch.tensor([dt], dtype=torch.float64, device=dev)
    dist.all_reduce(checked, group=group)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
    checked, dt = int(checked), float(slowest)
    total_bytes = checked * dim * 4
    say(f"looked up {checked} rows across {world} hosts in "
        f"{dt * 1e3:.1f} ms ({total_bytes / dt / 1e9:.2f} GB/s) — "
        "all verified, padding returned zeros")
    return 0


if __name__ == "__main__":
    sys.exit(main())
