"""Static hop shapes and the message-passing hop type (counterpart of
the first part of ``quiver_tpu/pyg/sage_sampler.py``).

The sampler classes themselves wait for a later slice of the port.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class Adj:
    """One message-passing hop, PyG orientation (source -> target).

    edge_index: [2, cap_edges] int32, -1 fill; row 0 = source
                (neighbour) local id, row 1 = target (seed) local id.
    e_id:       [cap_edges] global edge ids when tracked, else None.
    size:       (cap_source_nodes, cap_target_nodes) static capacities.
    mask:       [cap_edges] bool validity of each edge slot.

    Destructures like PyG's: ``edge_index, e_id, size = adj``.
    """

    __slots__ = ("edge_index", "e_id", "size", "mask")

    def __init__(self, edge_index: torch.Tensor,
                 e_id: Optional[torch.Tensor], size,
                 mask: Optional[torch.Tensor] = None):
        self.edge_index = edge_index
        self.e_id = e_id
        self.size = tuple(size)
        self.mask = mask if mask is not None else edge_index[0] >= 0

    def __iter__(self):
        return iter((self.edge_index, self.e_id, self.size))


class _LayerShape(NamedTuple):
    num_seeds: int
    fanout: int
    n_id_cap: int


def layer_shapes(batch_size: int, sizes: Sequence[int]) -> List[_LayerShape]:
    """Each hop's static seed count, fanout and frontier capacity
    ``s * (1 + k)``."""
    shapes = []
    s = batch_size
    for k in sizes:
        cap = s + s * k
        shapes.append(_LayerShape(num_seeds=s, fanout=k, n_id_cap=cap))
        s = cap
    return shapes
