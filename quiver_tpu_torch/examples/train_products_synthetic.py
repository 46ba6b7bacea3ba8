"""End-to-end GraphSAGE training on a synthetic ogbn-products-scale graph.

The port's counterpart of the JAX package's
``examples/train_products_synthetic.py`` (the reference's flagship
examples/pyg/reddit_quiver.py and examples/multi_gpu/pyg/ogb-products/
dist_sampling_ogb_products_quiver.py): a neighbour sampler and the
tiered feature store feeding a GraphSAGE training loop. A fully-cached
store runs the train step (``build_train_step``: sample, gather,
forward, backward and Adam in one call); a store with a host tier
samples on the device and fetches each batch's rows through the store,
double-buffered by ``Feature.prefetch`` (``build_split_train_step``).
The host tier lies pinned (``host_placement="offload"``) and the card's
row gather reads it.

``--data-parallel`` runs one process per rank (``torchrun``'s, else one
per visible card, or two gloo ranks with ``--device cpu``), each with
the whole table, averaging gradients (``build_e2e_train_step``); rank 0
prints. No dataset download is needed: the graph is a planted-partition
synthetic with products-like scale knobs. Swap in real
``edge_index``/features via the ``--npz`` flag (expects keys edge_index,
feat, labels, train_idx).

Usage: python -m quiver_tpu_torch.examples.train_products_synthetic
       [--nodes N] [--cache 1GB] [--sampling exact|rotation|window]
       [--data-parallel] [--trace [PATH]] [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks


def synthetic(n, avg_deg, dim, classes, seed=0):
    rng = np.random.default_rng(seed)
    deg = np.minimum(
        rng.lognormal(np.log(avg_deg), 1.0, n).astype(np.int64), 10_000)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]), dtype=np.int32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    centers = rng.standard_normal((classes, dim)).astype(np.float32)
    feat = centers[labels] + \
        0.5 * rng.standard_normal((n, dim)).astype(np.float32)
    perm = rng.permutation(n)
    train_idx = perm[: n // 10].astype(np.int32)
    test_idx = perm[n // 10: n // 10 + n // 20].astype(np.int32)
    return indptr, indices, feat, labels, train_idx, test_idx


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--avg-deg", type=int, default=15)
    p.add_argument("--dim", type=int, default=100)
    p.add_argument("--classes", type=int, default=47)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--sizes", type=int, nargs="+", default=[15, 10, 5])
    p.add_argument("--cache", default="1GB",
                   help="device cache budget for the feature store")
    p.add_argument("--cache-policy", default="device_replicate",
                   choices=["device_replicate", "p2p_clique_replicate"],
                   help="p2p_clique_replicate row-shards the hot set over "
                        "all devices (the papers100M-scale layout)")
    p.add_argument("--sampling", default="exact",
                   choices=["exact", "rotation", "window"],
                   help="rotation/window: the wide-row-fetch TPU paths "
                        "(fused and tiered stores both)")
    p.add_argument("--layout", default="overlap",
                   choices=["pair", "overlap"],
                   help="rotation row layout (overlap = one 256-wide "
                        "gather per seed, the fastest measured config)")
    p.add_argument("--shuffle", default="sort",
                   choices=["sort", "butterfly"],
                   help="per-epoch row reshuffle (butterfly = ~40x "
                        "cheaper masked swap network)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all local devices")
    p.add_argument("--eval-batches", type=int, default=20,
                   help="test-accuracy batches after training (0 = skip)")
    p.add_argument("--npz", "--data-dir", dest="npz", default=None,
                   help="real dataset: an .npz bundle or a directory of "
                        ".npy files (keys edge_index, feat, labels, "
                        "train_idx[, valid_idx, test_idx] — the standard "
                        "OGB dump, see quiver_tpu_torch.datasets)")
    p.add_argument("--trace", nargs="?", const="train_trace.json",
                   default=None, metavar="PATH",
                   help="record per-step host spans "
                        "(quiver_tpu_torch.tracing; "
                        "fully-cached path also collects the device "
                        "counters, so epoch spans carry the derived "
                        "hit-rate/dup-factor ratios) and export a "
                        "Perfetto-loadable trace JSON")
    _ranks.add_device_flag(p)
    return p


def cache_mesh(dev):
    """The clique of ``--cache-policy p2p_clique_replicate``: every
    visible card on one ``cache`` axis (the CPU once with ``--device
    cpu``). One card makes a clique of one, which the store keeps
    replicated, as the JAX package's does."""
    from ..parallel import make_mesh
    return make_mesh(("cache",), devices=[dev] if dev.type == "cpu"
                     else None)


def count_correct(logits, labels_batch):
    """``(correct, labeled)`` of one eval batch: the argmax of
    ``logits`` (the batch's rows) against ``labels_batch``, a NaN label
    (papers100M-style unlabeled) counting in neither."""
    pred = logits.argmax(-1).cpu().numpy()
    y = np.asarray(labels_batch, dtype=np.float64)
    ok = np.isfinite(y)
    return int((pred[ok] == y[ok].astype(np.int64)).sum()), int(ok.sum())


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    # compare parsed values to the parser defaults (argparse-accepted
    # forms like --shuffle=butterfly or abbreviations would bypass a
    # literal sys.argv scan); --layout is meaningful in every mode now
    # (exact uses it for the wide-fetch rows view), --shuffle is not
    if args.sampling == "exact" and args.shuffle != p.get_default("shuffle"):
        sys.exit("--shuffle only applies to rotation/window sampling "
                 "(exact needs no reshuffle); add --sampling rotation "
                 "(or window) or drop the flag — exact mode would "
                 "silently ignore it")
    if args.data_parallel:
        return _ranks.run(train, args)
    from ..utils.device import resolve_device
    return train(args, 0, 1, None, resolve_device(args.device))


def load_data(args, dev):
    """``(topo, indptr, indices, feat, labels, train_idx, test_idx)``:
    the ``--npz`` dataset or the synthetic graph; the topology on
    ``dev``, the rest numpy."""
    from ..datasets import from_numpy_dir
    from ..utils import CSRTopo
    if args.npz:
        # the dataset adapter accepts an .npz bundle or a directory of
        # .npy files (see quiver_tpu_torch/datasets.py for the OGB
        # export one-liner that produces either)
        ds = from_numpy_dir(args.npz, device=dev)
        topo = ds.csr_topo
        test_idx = (ds.test_idx if ds.test_idx is not None
                    else ds.valid_idx)
        if args.classes < ds.num_classes:
            args.classes = ds.num_classes
        return (topo, topo.indptr.cpu().numpy(), topo.indices.cpu().numpy(),
                ds.feat, ds.labels, ds.train_idx, test_idx)
    indptr, indices, feat, labels, train_idx, test_idx = synthetic(
        args.nodes, args.avg_deg, args.dim, args.classes)
    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    return topo, indptr, indices, feat, labels, train_idx, test_idx


def train(args, rank, world, group, dev) -> int:
    """One rank's run (the whole run without ``--data-parallel``)."""
    import torch

    from .. import tracing
    from ..feature import Feature
    from ..metrics import StepStats
    from ..models import GraphSAGE
    from ..ops import (as_index_rows, as_index_rows_overlapping,
                       edge_row_ids, reshuffle_csr, sample_multihop)
    from ..parallel import (build_e2e_train_step, build_split_train_step,
                            build_train_step, init_state, layers_to_adjs,
                            masked_feature_gather)
    from ..parallel.dist import rank_step_seeds

    say = print if rank == 0 else _ranks.quiet
    topo, indptr, indices, feat_np, labels, train_idx, test_idx = \
        load_data(args, dev)

    mesh_for_cache = None
    if args.cache_policy == "p2p_clique_replicate":
        mesh_for_cache = cache_mesh(dev)
    # tiered feature store: hottest rows on the card (degree-ordered),
    # the rest pinned in host memory
    feature = Feature(device_cache_size=args.cache, csr_topo=topo,
                      cache_policy=args.cache_policy, mesh=mesh_for_cache,
                      host_placement="offload", device=dev)
    feature.from_cpu_tensor(feat_np)
    say(f"feature store: {feature.cache_rows}/{feat_np.shape[0]} rows "
        f"cached in HBM")

    sizes = list(args.sizes)
    bs = args.batch
    per_dev = bs // world
    torch.manual_seed(1)          # every rank starts from the same weights
    model = GraphSAGE(feat_np.shape[1], args.hidden, args.classes,
                      len(sizes)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    state = init_state(model, opt)

    indptr_j = topo.indptr
    indices_j = topo.indices
    # fully cached (+ a replicated hot tier): the gather runs inside the
    # train step; otherwise sample on the device and fetch each batch's
    # rows through the tiered store (host tier included) like the
    # reference
    fully_cached = (feature.cache_rows == feat_np.shape[0]
                    and args.cache_policy == "device_replicate")
    feat_j = feature.device_part if fully_cached else None
    forder = feature.feature_order if fully_cached else None

    # rotation/window state: per-epoch refreshed rows view (+ the
    # butterfly's composed permuted state)
    windowed = args.sampling in ("rotation", "window")
    stride = 128 if args.layout == "overlap" else None
    as_rows = (as_index_rows_overlapping if stride else as_index_rows)
    row_ids = (edge_row_ids(indptr_j, int(indices_j.shape[0]))
               if windowed else None)
    permuted_j = indices_j
    # exact mode: a static layout view of the UN-shuffled indices routes
    # the draw through the wide-fetch exact path (same i.i.d. draw,
    # fewer scattered loads); no per-epoch refresh needed
    exact_rows = None if windowed else as_rows(indices_j)

    def refresh_rows(epoch):
        nonlocal permuted_j
        src = permuted_j if args.shuffle == "butterfly" else indices_j
        permuted_j = reshuffle_csr(
            src, row_ids,
            torch.Generator(device=dev).manual_seed(777_000 + epoch),
            method=args.shuffle)
        return as_rows(permuted_j)

    # --trace: host-side span timeline for every step; the fully-cached
    # steps also return the device counter vector (collect_metrics: no
    # extra host syncs per step), so the per-epoch span is annotated
    # with the DERIVED ratios (frontier fill) via StepStats
    trace_on = bool(args.trace) and rank == 0
    if trace_on:
        tracing.enable()
    stats = StepStats()
    metered = bool(args.trace)

    def labels_of(idx):
        return torch.as_tensor(np.asarray(labels[idx])).to(dev)

    sample_fn = apply_fn = None
    if not fully_cached:
        if args.data_parallel:
            say("NOTE: --data-parallel applies to the fused fully-cached "
                "path; the tiered-store path runs single-program "
                "(full batch)")
            if rank:
                feature.close()
                return 0
        sample_fn, apply_fn = build_split_train_step(
            model, opt, sizes, bs, method=args.sampling,
            indices_stride=stride)
    elif args.data_parallel:
        step = build_e2e_train_step(model, opt, sizes, per_dev, group,
                                    method=args.sampling,
                                    indices_stride=stride,
                                    collect_metrics=metered)
    else:
        step = build_train_step(model, opt, sizes, per_dev,
                                method=args.sampling,
                                indices_stride=stride,
                                collect_metrics=metered)

    rng = np.random.default_rng(0)
    it = 0
    for epoch in range(args.epochs):
        perm = rng.permutation(train_idx)
        rows = refresh_rows(epoch) if windowed else exact_rows
        t0 = time.perf_counter()
        epoch_loss, nb = 0.0, 0
        starts = list(range(0, len(perm) - bs + 1, bs))
        if fully_cached:
            for lo in starts:
                mine = perm[lo + rank * per_dev: lo + (rank + 1) * per_dev]
                seeds = torch.as_tensor(mine.astype(np.int32)).to(dev)
                hop_seeds, dropout_seed = rank_step_seeds(it, rank,
                                                          len(sizes))
                ts = time.perf_counter()
                # exact mode: rows is the static un-shuffled view
                # (wide-fetch exact path; permuted_j is indices_j)
                out = step(state, feat_j, forder, indptr_j, permuted_j,
                           seeds, labels_of(mine), hop_seeds,
                           dropout_seed, rows)
                if metered:
                    state, loss, counters = out
                else:
                    state, loss = out
                it += 1
                epoch_loss += float(loss)   # syncs on the step
                nb += 1
                if trace_on:
                    dt_s = time.perf_counter() - ts
                    stats.record_step(dt_s, counters)
                    tracing.record("train.step", ts, dt_s,
                                   args={"epoch": epoch, "batch": nb - 1})
        elif starts:
            # tiered path, double-buffered: sample batch i+1 and prefetch
            # its feature rows (the lookup runs on the store's staging
            # thread and stream) while batch i's model step computes
            def stage(lo, seed):
                seeds = torch.as_tensor(
                    perm[lo:lo + bs].astype(np.int32)).to(dev)
                n_id, adjs = sample_fn(indptr_j, permuted_j, seeds, seed,
                                       rows)
                return adjs, feature.prefetch(n_id), \
                    labels_of(perm[lo:lo + bs])

            nxt = stage(starts[0], it)
            for bi, lo in enumerate(starts):
                adjs, fut, y = nxt
                if bi + 1 < len(starts):
                    nxt = stage(starts[bi + 1], it + 1)
                ts = time.perf_counter() if trace_on else 0.0
                state, loss = apply_fn(state, fut.result(), adjs, y,
                                       1_000_000 + it)
                it += 1
                epoch_loss += float(loss)
                nb += 1
                if trace_on:
                    tracing.record("train.step", ts,
                                   time.perf_counter() - ts,
                                   args={"epoch": epoch, "batch": bi})
        dt = time.perf_counter() - t0
        if trace_on:
            # epoch span annotated with the observed derived ratios (the
            # counters the fully-cached step carried out); None entries
            # (path not exercised) dropped for the trace viewer
            derived = {k: round(v, 4)
                       for k, v in stats.snapshot()["derived"].items()
                       if v is not None}
            tracing.record("train.epoch", t0, dt,
                           args={"epoch": epoch, "steps": nb, **derived})
        say(f"epoch {epoch}: loss {epoch_loss / max(nb, 1):.4f}  "
            f"{dt:.2f}s  ({nb * bs / dt:.0f} seeds/s)")

    # -- sampled-neighborhood test accuracy (the reference's flagship
    # example reports ~0.787 on ogbn-products this way,
    # dist_sampling_ogb_products_quiver.py:1); rank 0 alone --
    if rank == 0 and args.eval_batches and test_idx is not None \
            and len(test_idx) < bs:
        say(f"eval skipped: {len(test_idx)} test nodes < batch {bs} "
            "(lower --batch or --eval-batches 0 to silence)")
    if rank == 0 and args.eval_batches and test_idx is not None \
            and len(test_idx) >= bs:
        if args.epochs == 0:
            # no training epoch built a rows view yet
            rows = refresh_rows(0) if windowed else exact_rows
        # else: the last epoch's rows/permuted_j pair is still in scope
        # and any consistent shuffle is valid for eval — no extra
        # reshuffle
        model.eval()
        correct = tot = 0
        ev = 0
        for lo in range(0, len(test_idx) - bs + 1, bs):
            if ev >= args.eval_batches:
                break
            ev += 1
            batch_idx = test_idx[lo:lo + bs]
            seeds = torch.as_tensor(batch_idx.astype(np.int32)).to(dev)
            with torch.no_grad():
                if sample_fn is not None:    # tiered path: reuse it
                    n_id, adjs = sample_fn(indptr_j, permuted_j, seeds,
                                           10_000_000 + ev, rows)
                    x = feature[n_id]
                else:
                    gen = torch.Generator(device=dev).manual_seed(
                        10_000_000 + ev)
                    n_id, layers = sample_multihop(
                        indptr_j, permuted_j, seeds, sizes, gen,
                        method=args.sampling, indices_rows=rows,
                        indices_stride=stride if rows is not None
                        else None, seeds_dense=True)
                    adjs = layers_to_adjs(layers, bs, sizes)
                    x = masked_feature_gather(feat_j, n_id, forder)
                logits = model(x, adjs)[:bs]
            c, t = count_correct(logits, labels[batch_idx])
            correct += c
            tot += t
        if tot:
            say(f"test accuracy: {correct / tot:.4f} "
                f"({tot} labeled test nodes, {ev} batches)")

    if trace_on:
        n = tracing.export_chrome_trace(args.trace)
        say(f"wrote {n} spans to {args.trace} — load at "
            "https://ui.perfetto.dev")
    feature.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
