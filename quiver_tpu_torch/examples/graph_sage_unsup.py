"""Unsupervised GraphSAGE: link-prediction loss with random-walk positives.

The port's counterpart of the JAX package's
``examples/graph_sage_unsup.py`` (the reference workflow in
examples/pyg/graph_sage_unsup_quiver.py): for each batch of nodes draw a
1-step random-walk positive and a uniform negative, sample the k-hop
neighborhood of the tripled batch, and minimize
-log sigma(z_u . z_pos) - log sigma(-z_u . z_neg).

Runs on a synthetic community graph (no dataset download in this
environment); prints link-prediction AUC on held-out edges, which rises
well above 0.5 as the embeddings learn the community structure.

Usage: python -m quiver_tpu_torch.examples.graph_sage_unsup
       [--nodes N] [--epochs E] [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks

SIZES = [10, 10]


def make_community_graph(rng, n, communities=16, p_in=0.02, p_out=0.0005,
                         dim=64):
    """Sparse SBM-ish graph + community-correlated features."""
    comm = rng.integers(0, communities, n)
    src, dst = [], []
    # sample edges community-blockwise to stay sparse
    for c in range(communities):
        members = np.flatnonzero(comm == c)
        m = len(members)
        deg_in = max(1, int(p_in * m))
        for _ in range(deg_in):
            src.append(members)
            dst.append(rng.choice(members, m))
    deg_out = max(1, int(p_out * n))
    all_nodes = np.arange(n)
    for _ in range(deg_out):
        src.append(all_nodes)
        dst.append(rng.integers(0, n, n))
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # symmetrize
    edge_index = np.stack([np.concatenate([src, dst]),
                           np.concatenate([dst, src])])
    base = rng.standard_normal((communities, dim)) * 0.5
    feat = (base[comm] + rng.standard_normal((n, dim))).astype(np.float32)
    # row-normalize like the reference's T.NormalizeFeatures() — keeps
    # dot-product logits in a stable range for the sigmoid loss
    feat /= np.maximum(np.linalg.norm(feat, axis=1, keepdims=True), 1e-6)
    return edge_index, feat, comm


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=10000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--hidden", type=int, default=64)
    _ranks.add_device_flag(p)
    return p


def link_loss(model, x, adjs, batch_locals, bs: int):
    """The loss over one sampled block of the ``[batch | positives |
    negatives]`` triple: the model's rows mapped back to the triple
    through ``batch_locals``, then ``-(mean log sigma(z_u . z_pos) +
    mean log sigma(-z_u . z_neg))``."""
    import torch.nn.functional as F
    z = model(x, adjs)[:3 * bs][batch_locals.long()]
    zu, zp, zn = z[:bs], z[bs:2 * bs], z[2 * bs:]
    pos_logit = (zu * zp).sum(1)
    neg_logit = (zu * zn).sum(1)
    return -(F.logsigmoid(pos_logit).mean()
             + F.logsigmoid(-neg_logit).mean())


def unsup_loss(model, feat, indptr, indices, seeds, generator):
    """One batch's link-prediction loss: a random-walk positive and a
    uniform negative per seed (both from ``generator``, on the seeds'
    device), the k-hop block of the triple, then :func:`link_loss`."""
    import torch

    from ..ops import random_walk_step, sample_multihop_dedup
    from ..parallel import layers_to_adjs, masked_feature_gather
    bs = seeds.shape[0]
    with torch.no_grad():
        pos = random_walk_step(indptr, indices, seeds, generator)
        neg = torch.randint(0, indptr.shape[0] - 1, (bs,),
                            generator=generator, device=seeds.device,
                            dtype=torch.int32)
        # the triple may contain duplicates (pos/neg can hit seeds) ->
        # dedup + map outputs back through batch_locals
        batch = torch.cat([seeds, pos, neg])
        n_id, layers, blocals = sample_multihop_dedup(
            indptr, indices, batch, SIZES, generator)
        x = masked_feature_gather(feat, n_id)
    adjs = layers_to_adjs(layers, 3 * bs, SIZES)
    return link_loss(model, x, adjs, blocals, bs)


def auc(z, nodes, eval_pos, eval_neg) -> float:
    """Link AUC, P(pos score > neg score): ``z[i]`` embeds ``nodes[i]``,
    a pair's score is the dot product of its ends' embeddings."""
    lut = {g: i for i, g in enumerate(nodes)}

    def score(pairs):
        a = z[[lut[g] for g in pairs[0]]]
        b = z[[lut[g] for g in pairs[1]]]
        return (a * b).sum(1)
    sp, sn = score(eval_pos), score(eval_neg)
    return (sp[:, None] > sn[None, :]).mean()


def embed(model, feat, indptr, indices, nodes, generator):
    """The model's rows for ``nodes`` over one sampled block."""
    import torch

    from ..ops import sample_multihop
    from ..parallel import layers_to_adjs, masked_feature_gather
    with torch.no_grad():
        n_id, layers = sample_multihop(indptr, indices, nodes, SIZES,
                                       generator)
        x = masked_feature_gather(feat, n_id)
        adjs = layers_to_adjs(layers, nodes.shape[0], SIZES)
        return model(x, adjs)[: nodes.shape[0]]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)

    import torch

    from ..models import GraphSAGE
    from ..utils import CSRTopo

    rng = np.random.default_rng(0)
    edge_index, feat_np, comm = make_community_graph(rng, args.nodes)
    topo = CSRTopo(edge_index=edge_index, device=dev)
    indptr, indices = topo.indptr, topo.indices
    feat = torch.as_tensor(feat_np).to(dev)
    bs = args.batch

    torch.manual_seed(1)
    model = GraphSAGE(feat_np.shape[1], args.hidden, args.hidden, 2,
                      dropout=0.0).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    # held-out eval edges + random non-edges for AUC
    eval_pos = edge_index[:, rng.choice(edge_index.shape[1], 2000,
                                        replace=False)]
    eval_neg = rng.integers(0, args.nodes, (2, 2000))

    def link_auc(seed):
        zs = []
        all_nodes = np.unique(np.concatenate(
            [eval_pos.reshape(-1), eval_neg.reshape(-1)]))
        pad = (-len(all_nodes)) % bs
        padded = np.concatenate([all_nodes, np.zeros(pad, np.int64)])
        for i in range(0, len(padded), bs):
            nodes = torch.as_tensor(padded[i:i + bs].astype(np.int32))
            zs.append(embed(model, feat, indptr, indices, nodes.to(dev),
                            torch.Generator(device=dev).manual_seed(
                                seed + i)).cpu().numpy())
        z = np.concatenate(zs)[: len(all_nodes)]
        return auc(z, all_nodes, eval_pos, eval_neg)

    train_nodes = np.arange(args.nodes)
    steps_per_epoch = args.nodes // bs
    for epoch in range(args.epochs):
        rng.shuffle(train_nodes)
        model.train()
        t0, tot = time.time(), 0.0
        for i in range(steps_per_epoch):
            seeds = torch.as_tensor(
                train_nodes[i * bs:(i + 1) * bs].astype(np.int32)).to(dev)
            gen = torch.Generator(device=dev).manual_seed(
                epoch * 10000 + i)
            loss = unsup_loss(model, feat, indptr, indices, seeds, gen)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += float(loss.detach())
        model.eval()
        a = link_auc(999)
        print(f"epoch {epoch}: loss {tot / steps_per_epoch:.4f}  "
              f"link-AUC {a:.3f}  {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
