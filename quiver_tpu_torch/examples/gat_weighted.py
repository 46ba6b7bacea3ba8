"""GAT with attention-weighted neighbor sampling (BASELINE configs[4]).

The port's counterpart of the JAX package's ``examples/gat_weighted.py``.
The reference pairs its GAT workloads with weighted sampling: neighbors
drawn proportional to an edge weight (its ``weight_sample`` CDF kernel,
cuda_random.cu.hpp:178-221). Here the weights feed
``sample_multihop(edge_weight=...)`` and the port's GAT consumes the
masked layers. Edge weights start uniform and are refreshed between
epochs — the classic attention-weighted-sampling loop.

Usage: python -m quiver_tpu_torch.examples.gat_weighted
       [--sampling exact|rotation] [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks

SIZES = [10, 5]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--avg-deg", type=int, default=10)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--sampling", default="exact",
                   choices=["exact", "rotation"],
                   help="rotation = the windowed weighted draw (wide "
                        "row fetches over co-shuffled index/weight "
                        "layouts; weight-exact for deg <= 129)")
    _ranks.add_device_flag(p)
    return p


def make_graph(rng, n, avg_deg, dim, classes):
    """The example's lognormal graph and planted features, numpy:
    ``(deg, indptr, indices, labels, centers, feat)``."""
    deg = np.minimum(rng.lognormal(np.log(avg_deg), 0.8, n)
                     .astype(np.int64) + 1, 2000)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = rng.integers(0, n, e, dtype=np.int32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    centers = rng.standard_normal((classes, dim)).astype(np.float32)
    feat = centers[labels] + \
        0.7 * rng.standard_normal((n, dim)).astype(np.float32)
    return deg, indptr, indices, labels, centers, feat


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)

    import torch

    from ..models import GAT
    from ..ops import (as_index_rows_overlapping, edge_row_ids,
                       reshuffle_csr, sample_multihop)
    from ..parallel import (cross_entropy_logits, layers_to_adjs,
                            masked_feature_gather)
    from ..utils import CSRTopo

    rng = np.random.default_rng(0)
    n = args.nodes
    _, indptr, indices, labels, _, feat = make_graph(
        rng, n, args.avg_deg, args.dim, args.classes)
    e = int(indptr[-1])

    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    # initial edge weights: uniform (refreshed below)
    edge_weight = np.ones(e, np.float32)

    bs = args.batch
    torch.manual_seed(1)
    model = GAT(args.dim, 64, args.classes, 2, heads=4, dropout=0.0).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    indptr_j = topo.indptr
    indices_j = topo.indices
    feat_j = torch.as_tensor(feat).to(dev)

    windowed = args.sampling == "rotation"

    def fused_loss(weights, seeds, y, generator, rows, w_rows):
        with torch.no_grad():
            n_id, layers = sample_multihop(
                indptr_j, indices_j, seeds, SIZES, generator,
                edge_weight=weights, method=args.sampling,
                indices_rows=rows, weight_rows=w_rows,
                indices_stride=128 if windowed else None)
            x = masked_feature_gather(feat_j, n_id)
        adjs = layers_to_adjs(layers, bs, SIZES)
        return cross_entropy_logits(model(x, adjs)[:bs], y)

    rids = edge_row_ids(indptr_j, e) if windowed else None

    def shuffled_views(weights, generator):
        """Co-shuffle indices+weights and build the overlap layouts
        (refresh per epoch AND after every weight update — the weight
        rows must mirror the current weights)."""
        permuted, (wp,) = reshuffle_csr(indices_j, rids, generator,
                                        extra=(weights,))
        return (as_index_rows_overlapping(permuted),
                as_index_rows_overlapping(wp))

    train_idx = np.arange(n)
    weights_j = torch.as_tensor(edge_weight).to(dev)
    for epoch in range(args.epochs):
        rng.shuffle(train_idx)
        rows = w_rows = None
        if windowed:
            rows, w_rows = shuffled_views(
                weights_j, torch.Generator(device=dev).manual_seed(
                    555 + epoch))
        model.train()
        t0, tot, nb = time.time(), 0.0, 0
        for lo in range(0, min(len(train_idx), 40 * bs) - bs + 1, bs):
            seeds = torch.as_tensor(
                train_idx[lo:lo + bs].astype(np.int32)).to(dev)
            y = torch.as_tensor(labels[train_idx[lo:lo + bs]]).to(dev)
            loss = fused_loss(weights_j, seeds, y,
                              torch.Generator(device=dev).manual_seed(
                                  epoch * 10000 + nb), rows, w_rows)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += float(loss.detach())
            nb += 1
        # refresh sampling weights from degree-normalized attention proxy:
        # upweight edges into high-degree hubs (cheap stand-in for reading
        # trained attention scores back; same plumbing either way)
        deg_j = torch.as_tensor(np.diff(indptr).astype(np.float32)).to(dev)
        weights_j = 0.5 + deg_j[indices_j.long()] / deg_j.max()
        print(f"epoch {epoch}: loss {tot / max(nb, 1):.4f}  "
              f"{time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
