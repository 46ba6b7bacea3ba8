"""Model FLOPs of one step on the sizes a sampled block really has.

A block has ``targets`` valid target rows, ``sources`` valid source
rows and ``edges`` valid edges. A product of an ``[m, a]`` by an ``[a,
b]`` matrix counts ``2 m a b``. The backward of a product counts twice
its forward (the weight's gradient and the input's), except where the
input needs no gradient (the first layer's features), where it counts
once. Element-wise work (activations, dropout) and the mean's sums over
edges count one FLOP a value a pass.
"""

from __future__ import annotations

from typing import Sequence, Tuple

Sizes = Tuple[int, int, int]     # (targets, sources, edges)


def sage_layer(t: int, e: int, din: int, dout: int) -> int:
    """Forward: two products (root and neighbour mean) of ``t`` rows,
    the mean's sum over ``e`` edges."""
    return 2 * 2 * t * din * dout + e * din + t * din


def sage_step(blocks: Sequence[Sizes], dims: Sequence[int],
              train: bool = True) -> int:
    total = 0
    for i, (t, _, e) in enumerate(blocks):
        fwd = sage_layer(t, e, dims[i], dims[i + 1])
        mm = 2 * 2 * t * dims[i] * dims[i + 1]
        total += fwd
        if train:
            total += mm * (1 if i == 0 else 2) + e * dims[i]
    return total
