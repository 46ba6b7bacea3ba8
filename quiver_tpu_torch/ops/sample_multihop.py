"""Multi-hop sampling, the exact route (counterpart of
``quiver_tpu/ops/sample_multihop.py: sample_multihop``).

Every hop runs the exact i.i.d. sampler ``sample.sample_layer`` and
compacts its picks into the next hop's frontier. All hops draw, in
order, from the one ``torch.Generator`` the call is given, where the
JAX function folds its key per hop. Weighted sampling, the windowed
methods (``rotation``, ``window``), the wide-exact ``indices_rows``
view, edge ids and the metrics collector are later work.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .sample import LayerSample, compact_layer, sample_layer

_VARIANTS = "ROADMAP Queue 1 item 4 'Sampling core and variants'"


def sample_multihop(indptr: torch.Tensor, indices: torch.Tensor,
                    seeds: torch.Tensor, sizes: Sequence[int],
                    generator: torch.Generator, edge_weight=None,
                    method: str = "exact", indices_rows=None, eid=None,
                    seeds_dense: bool = False, collector=None,
                    ) -> Tuple[torch.Tensor, List[LayerSample]]:
    """Expand ``seeds`` through ``sizes`` hops. Returns the final
    frontier ``n_id`` (static capacity, -1 fill) and the per-hop
    ``LayerSample``s in sampling order (innermost target hop first).

    ``generator`` is a ``torch.Generator`` on the seeds' device.
    ``seeds_dense`` promises the hop-0 seeds are valid-first (-1 fill
    only at the tail); later hops always are. The other knobs of the
    JAX function raise ``NotImplementedError``."""
    if method != "exact":
        raise NotImplementedError(f"method={method!r}: {_VARIANTS}")
    for name, arg in (("edge_weight", edge_weight),
                      ("indices_rows", indices_rows), ("eid", eid),
                      ("collector", collector)):
        if arg is not None:
            raise NotImplementedError(f"{name}: {_VARIANTS}")
    cur = seeds.to(torch.int32)
    layers: List[LayerSample] = []
    for i, k in enumerate(sizes):
        nbrs, _ = sample_layer(indptr, indices, cur, int(k), generator)
        layers.append(compact_layer(cur, nbrs,
                                    seeds_dense=(i > 0) or seeds_dense))
        cur = layers[-1].n_id
    return cur, layers
