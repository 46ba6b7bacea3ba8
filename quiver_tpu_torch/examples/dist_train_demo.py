"""Multi-host training with partitioned features — the full loop.

The port's counterpart of the JAX package's
``examples/dist_train_demo.py`` (the reference's multi-node benchmark,
benchmarks/ogbn-papers100M/train_quiver_multi_node.py: per-rank DDP +
NCCL DistFeature): probability-partition the features over the ranks of
a ``torch.distributed`` group (``torchrun``'s, else one rank per visible
card over NCCL, or two gloo ranks with ``--device cpu``), then train
GraphSAGE where every step is ``build_dist_train_step``: per-rank
sampling, the ``all_to_all`` feature exchange (features never leave
their owning rank except as responses), forward/backward and averaged
gradients. Rank 0 prints.

Usage: python -m quiver_tpu_torch.examples.dist_train_demo
       [--device cuda|cpu]
       torchrun --nproc-per-node 4 -m quiver_tpu_torch.examples.dist_train_demo
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks
from .dist_feature_demo import partition

SIZES = [10, 5]
PER_HOST = 128


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    _ranks.add_device_flag(p)
    return p


def make_data(rng):
    """The planted-partition graph (learnable labels), numpy: ``(n,
    dim, classes, labels, indptr, indices, feat, train_idx)``."""
    n, dim, classes = 24_000, 64, 8
    labels = rng.integers(0, classes, n).astype(np.int32)
    deg = np.maximum(rng.poisson(10, n), 1).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    same = rng.random(e) < 0.8
    row = np.repeat(np.arange(n), deg)
    indices = rng.integers(0, n, e).astype(np.int32)
    for c in range(classes):
        pool = np.flatnonzero(labels == c)
        m = same & (labels[row] == c)
        indices[m] = pool[rng.integers(0, pool.size, int(m.sum()))]
    centers = rng.standard_normal((classes, dim)).astype(np.float32)
    feat = 0.3 * centers[labels] + rng.standard_normal(
        (n, dim)).astype(np.float32)
    train_idx = rng.choice(n, n // 5, replace=False).astype(np.int32)
    return n, dim, classes, labels, indptr, indices, feat, train_idx


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return _ranks.run(demo, args)


def demo(args, rank, world, group, dev) -> int:
    import torch

    from ..comm import TorchComm
    from ..feature import DistFeature
    from ..models import GraphSAGE
    from ..parallel import build_dist_train_step, init_state, rank_step_seeds

    say = print if rank == 0 else _ranks.quiet
    say(f"mesh: {world} hosts ({dev.type})")

    # ---- planted-partition graph (learnable labels) ------------------------
    rng = np.random.default_rng(0)
    n, dim, classes, labels, indptr, indices, feat, train_idx = \
        make_data(rng)

    # ---- probability-driven partition across ranks -------------------------
    info = partition(indptr, indices, train_idx, SIZES, n, world, rank, dev)
    comm = TorchComm(rank=rank, world_size=world, group=group)
    dist_feat = DistFeature.from_partition(feat, info, comm, device=dev)
    say(f"features partitioned: {[int(s) for s in info.local_sizes]} "
        "rows per host")

    # ---- model + the multi-host step ---------------------------------------
    torch.manual_seed(1)          # every rank starts from the same weights
    model = GraphSAGE(dim, 128, classes, len(SIZES), dropout=0.0).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    state = init_state(model, opt)
    step = build_dist_train_step(model, opt, SIZES, PER_HOST, group,
                                 rows_per_host=dist_feat._rows_per_host)
    indptr_j = torch.as_tensor(indptr).to(dev)
    indices_j = torch.as_tensor(indices).to(dev)

    g = world * PER_HOST
    for epoch in range(3):
        perm = rng.permutation(train_idx)
        t0, losses = time.time(), []
        for lo in range(0, len(perm) - g + 1, g):
            mine = perm[lo + rank * PER_HOST: lo + (rank + 1) * PER_HOST]
            hop_seeds, dropout_seed = rank_step_seeds(epoch * 1000 + lo,
                                                      rank, len(SIZES))
            state, loss = step(state, dist_feat.shard, dist_feat._g2h,
                               dist_feat._g2l, indptr_j, indices_j,
                               torch.as_tensor(mine).to(dev),
                               torch.as_tensor(labels[mine]).to(dev),
                               hop_seeds, dropout_seed)
            losses.append(float(loss))
        say(f"epoch {epoch}: loss {np.mean(losses):.4f}  "
            f"{time.time() - t0:.1f}s  ({len(losses)} dist steps)")

    # ---- sanity: the exchange really served correct rows -------------------
    ids = rng.integers(0, n, g).astype(np.int32)
    mine = ids[rank * PER_HOST:(rank + 1) * PER_HOST]
    np.testing.assert_allclose(
        dist_feat[torch.as_tensor(mine).to(dev)].cpu().numpy(), feat[mine],
        rtol=1e-6)
    say("feature exchange verified against ground truth")
    return 0


if __name__ == "__main__":
    sys.exit(main())
