"""Degree-descending hot-order reindexing for cache placement (counterpart
of ``quiver_tpu/utils/reorder.py``, the reference ``reindex_by_config`` /
``reindex_feature``).

Host-side preprocessing in numpy, as in the JAX package: the feature
table may not fit on the card at this stage, and the shuffle draws from
numpy's generator, never torch's, so the port's ``new_order`` (and with
it the store's hot set) equals the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def reindex_by_config(adj_csr, graph_feature, gpu_portion: float,
                      seed: int = 0):
    """Returns ``(permuted_feature, new_order)``.

    ``prev_order[i]`` is the old node id stored at new row ``i``
    (degree-descending, the hot prefix shuffled); ``new_order[old_id]``
    is the new row of ``old_id``. ``graph_feature`` (numpy or a tensor)
    comes back as a numpy array, or None when it is None."""
    degree = _host(adj_csr.degree)
    node_count = degree.shape[0]
    prev_order = np.argsort(-degree, kind="stable")
    hot = int(node_count * gpu_portion)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(hot)
    prev_order[:hot] = prev_order[perm]
    new_order = np.empty(node_count, dtype=np.int64)
    new_order[prev_order] = np.arange(node_count, dtype=np.int64)
    feature = None
    if graph_feature is not None:
        feature = _host(graph_feature)[prev_order]
    return feature, new_order


def reindex_feature(graph, feature, ratio: float, seed: int = 0):
    """:func:`reindex_by_config` over a ``CSRTopo``'s degrees."""
    return reindex_by_config(graph, feature, ratio, seed=seed)
