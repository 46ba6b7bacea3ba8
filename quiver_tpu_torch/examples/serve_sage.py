"""Minimal online GNN serving: point queries through the micro-batch
server.

The port's counterpart of the JAX package's ``examples/serve_sage.py``.
Builds a synthetic graph + tiered feature store + GraphSAGE weights,
warms a two-step fanout ladder, then plays a short Poisson request
trace through ``MicroBatchServer`` and prints the serving report —
per-request p50/p95/p99, batch fill, shed mix, SLO budget burn.

``--trace [PATH]`` additionally records the span timeline
(``quiver_tpu_torch.tracing``) and exports Perfetto/Chrome trace-event
JSON: load it at https://ui.perfetto.dev to see each request's
admission -> coalesce -> dispatch -> scatter path, correlated to the
batch that carried it via the ``batch``/``trace_id`` span args.

Usage: python -m quiver_tpu_torch.examples.serve_sage
       [--rate 2000] [--seconds 3] [--batch-cap 32]
       [--trace [serve_trace.json]] [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np

from . import _ranks

FULL, SHED = [10, 5], [4, 2]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--batch-cap", type=int, default=32)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered requests/s (open-loop Poisson)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--slo-p99-ms", type=float, default=50.0)
    ap.add_argument("--trace", nargs="?", const="serve_trace.json",
                    default=None, metavar="PATH",
                    help="record host-side spans and export a "
                         "Perfetto-loadable trace JSON (default "
                         "serve_trace.json)")
    _ranks.add_device_flag(ap)
    return ap


def make_graph(rng, n, dim):
    """The example's graph and features, numpy: ``(deg, indptr,
    indices, feat)``."""
    deg = rng.poisson(8, n).astype(np.int64).clip(1)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]), dtype=np.int32)
    feat = rng.standard_normal((n, dim)).astype(np.float32)
    return deg, indptr, indices, feat


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)

    import torch

    from .. import tracing
    from ..feature import Feature
    from ..models import GraphSAGE
    from ..serving import (MicroBatchServer, OverloadError, ServeConfig,
                           ServeEngine)
    from ..utils import CSRTopo

    rng = np.random.default_rng(0)
    n = args.nodes
    _, indptr, indices, feat = make_graph(rng, n, args.dim)

    # a tiered store: 25% of rows cached on the card (degree-ordered),
    # the rest in a pinned host tier with unique-cold compaction — the
    # serve step reads it through the store's lookup, so cold-tier
    # traffic scales with unique misses
    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    store = Feature(device_cache_size=(n // 4) * args.dim * 4,
                    csr_topo=topo, dedup_cold=True,
                    host_placement="offload", device=dev)
    store.from_cpu_tensor(feat)

    torch.manual_seed(1)
    model = GraphSAGE(args.dim, 32, args.classes, 2, dropout=0.0)
    # (a real deployment restores trained weights via
    # quiver_tpu_torch.checkpoint instead)

    engine = ServeEngine(model, None, topo, store,
                         sizes_variants=[FULL, SHED],
                         batch_cap=args.batch_cap,
                         collect_metrics=True, device=dev)
    print("compiling the fanout ladder "
          f"{engine.variants} at batch_cap={args.batch_cap} ...")
    engine.warmup()

    if args.trace:
        tracing.enable()
    cfg = ServeConfig(max_wait_ms=2.0, queue_depth=1024,
                      slo_p99_ms=args.slo_p99_ms,
                      shed_queue_frac=0.25)
    with MicroBatchServer(engine, cfg) as server:
        n_req = int(args.rate * args.seconds)
        gaps = rng.exponential(1.0 / args.rate, n_req)
        futs, rejected = [], 0
        print(f"offering ~{args.rate:.0f} req/s for {args.seconds}s ...")
        t_next = time.perf_counter()
        for k in range(n_req):
            t_next += gaps[k]
            delay = t_next - time.perf_counter()
            if delay > 0.0015:
                time.sleep(delay - 0.001)
            try:
                futs.append(server.submit(int(rng.integers(0, n))))
            except OverloadError:
                rejected += 1
        rows = [f.result(timeout=60) for f in futs]
        print(f"served {len(rows)} requests ({rejected} shed at "
              f"admission); first row argmax = {int(rows[0].argmax())}")
        print()
        print(server.report())
    if args.trace:
        n = tracing.export_chrome_trace(args.trace)
        print(f"\nwrote {n} spans to {args.trace} — load it at "
              "https://ui.perfetto.dev (request<->batch correlation is "
              "in each span's trace_id/batch args)")
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
