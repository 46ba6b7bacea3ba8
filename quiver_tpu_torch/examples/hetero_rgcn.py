"""R-GCN on a heterogeneous (MAG240M-shaped) graph (BASELINE configs[3]).

The port's counterpart of the JAX package's ``examples/hetero_rgcn.py``.
Mini MAG: papers cite papers, authors write papers, authors affiliated
with institutions. The typed sampler expands the paper seed frontier
through every relation per hop; the R-GCN aggregates per relation with
its own weights. Mirrors the reference's ogbn-mag240m benchmark target
(benchmarks/ogbn-mag240m), which trains on the paper-cites-paper
projection — this example exercises the full multi-relation path.

Usage: python -m quiver_tpu_torch.examples.hetero_rgcn [--weighted]
       [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks

CITES = ("paper", "cites", "paper")
WRITES = ("author", "writes", "paper")
EMPLOYS = ("institution", "employs", "author")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--papers", type=int, default=8000)
    p.add_argument("--authors", type=int, default=4000)
    p.add_argument("--institutions", type=int, default=200)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--weighted", action="store_true",
                   help="attention-weighted draws on the cites relation "
                        "(per-relation edge_weight + with_eid)")
    _ranks.add_device_flag(p)
    return p


def rel_topo(rng, n_dst, n_src, avg_deg, device):
    """One relation's CSR (row v: a dst node's src in-neighbours) on
    ``device``."""
    from ..utils import CSRTopo
    deg = rng.integers(1, 2 * avg_deg, n_dst).astype(np.int64)
    indptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_src, int(indptr[-1]), dtype=np.int32)
    return CSRTopo(indptr=indptr, indices=indices, device=device)


def make_features(rng, counts, dim, classes):
    """``(labels, centers, feats)``: paper labels and each type's
    features, the papers' planted around their class centers."""
    labels = rng.integers(0, classes, counts["paper"]).astype(np.int32)
    centers = {t: rng.standard_normal((classes, dim))
               .astype(np.float32) for t in counts}
    feats = {t: rng.standard_normal((c, dim)).astype(np.float32)
             for t, c in counts.items()}
    feats["paper"] += 2.0 * centers["paper"][labels]
    return labels, centers, feats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)

    import torch

    from ..hetero import HeteroCSRTopo, HeteroGraphSageSampler
    from ..hetero_feature import HeteroFeature
    from ..models import RGCN
    from ..parallel import cross_entropy_logits

    rng = np.random.default_rng(0)
    counts = {"paper": args.papers, "author": args.authors,
              "institution": args.institutions}
    topo = HeteroCSRTopo(
        rels={
            CITES: rel_topo(rng, args.papers, args.papers, 8, dev),
            WRITES: rel_topo(rng, args.papers, args.authors, 3, dev),
            EMPLOYS: rel_topo(rng, args.authors, args.institutions, 2, dev),
        },
        node_counts=counts)

    labels, _, feats = make_features(rng, counts, args.dim, args.classes)

    sampler_kw = {}
    if args.weighted:
        # per-relation weighted (attention) draws: bias the cites
        # relation toward "influential" citations (synthetic exponential
        # weights, CSR-slot-aligned); with_eid stamps each sampled edge
        # with its slot so downstream attention can look weights back up
        e = int(topo.rels[CITES].indices.shape[0])
        sampler_kw = dict(
            edge_weight={CITES: rng.exponential(1.0, e).astype(np.float32)},
            with_eid=True)
    sampler = HeteroGraphSageSampler(topo, sizes=[4, 3], seed_type="paper",
                                     seed=0, device=dev, **sampler_kw)
    bs = args.batch

    # typed tiered stores (MAG240M-shaped placement): the big paper
    # matrix gets a small degree-ordered device cache + a pinned host
    # tier the card's gather reads, the small author/institution
    # matrices sit fully on the device — the same Feature machinery
    # (policies, host/disk tiers, prefetch) per type
    row_bytes = args.dim * 4
    hfeat = HeteroFeature.from_cpu_tensors(
        feats,
        configs={
            "paper": dict(
                device_cache_size=(args.papers // 4) * row_bytes,
                csr_topo=topo.rels[CITES]),
            "author": dict(device_cache_size=args.authors * row_bytes),
            "institution": dict(
                device_cache_size=args.institutions * row_bytes),
        },
        default=dict(host_placement="offload", device=dev))

    seeds = rng.choice(args.papers, bs, replace=False)
    _, _, layers = sampler.sample(seeds)
    torch.manual_seed(0)
    model = RGCN({t: args.dim for t in counts}, 64, args.classes, 2,
                 seed_type="paper",
                 edge_types=[list(layer.adjs) for layer in layers],
                 dropout=0.0).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    train = np.arange(args.papers)
    for epoch in range(args.epochs):
        rng.shuffle(train)
        model.train()
        t0, tot, nb = time.time(), 0.0, 0
        for lo in range(0, min(len(train), 30 * bs) - bs + 1, bs):
            seeds = train[lo:lo + bs]
            _, _, layers = sampler.sample(seeds)
            x = hfeat.lookup(layers[0].frontier)
            y = torch.as_tensor(labels[seeds]).to(dev)
            loss = cross_entropy_logits(model(x, layers)[:bs], y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += float(loss.detach())
            nb += 1
        print(f"epoch {epoch}: loss {tot / max(nb, 1):.4f}  "
              f"{time.time() - t0:.2f}s")
    hfeat.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
