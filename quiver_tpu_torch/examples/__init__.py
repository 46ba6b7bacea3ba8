"""The examples: counterparts of the JAX package's ``examples/`` scripts,
with the same flags, defaults, help text and printed lines, and one flag
more, ``--device {cuda,cpu}`` (the card by default; with ``cuda`` and no
card they raise, and never fall back to the CPU).

Each runs as ``python -m quiver_tpu_torch.examples.<name>`` and exposes
``main(argv=None) -> int``:

- ``train_products_synthetic``: supervised GraphSAGE on a synthetic
  ogbn-products-scale graph through the tiered ``Feature`` store (the
  fully-cached route, or the tiered route with ``Feature.prefetch``),
  exact, rotation or window sampling, ``--data-parallel`` (one process
  a rank), ``--cache-policy p2p_clique_replicate``, ``--npz`` and
  ``--trace``;
- ``graph_sage_unsup``: unsupervised GraphSAGE (random-walk positives,
  a link-prediction loss, link AUC);
- ``gat_weighted``: GAT over weighted sampling, the weights refreshed
  each epoch (``--sampling rotation``: the windowed weighted draw);
- ``hetero_rgcn``: R-GCN over a MAG-shaped typed graph and per-type
  tiered stores (``--weighted``: per-relation weighted draws);
- ``serve_sage``: point queries through ``MicroBatchServer`` over a
  tiered store, an open-loop Poisson trace and the server's report;
- ``dist_feature_demo`` and ``dist_train_demo``: the feature table
  partitioned over the ranks of a ``torch.distributed`` group,
  ``DistFeature`` lookups and the multi-host train step.

The multi-rank examples join ``torchrun``'s group when started under
it; started plainly they run one rank per visible card (one card: the
rank is this process), or two gloo ranks with ``--device cpu``.

Random streams are torch's: a run draws other samples, dropout masks,
negatives and initial weights than the JAX script's, from the same
numpy data (every numpy array is the JAX script's, bit for bit).
"""
