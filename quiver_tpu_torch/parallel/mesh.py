"""The group the multi-rank steps run over (counterpart of
``quiver_tpu/parallel/mesh.py``).

A JAX step names its parallelism by a mesh and one of its axes; here it
is a ``torch.distributed`` process group, one process per rank (None =
the default group). ``axis_size`` and ``axis_index`` are the group's
counterparts of ``mesh.shape[axis]`` and ``lax.axis_index(axis)``.
The mesh constructors and shardings of the JAX module (``make_mesh``,
``replicated``, ``row_sharded``) describe one controller over many
devices, which this port has not (ROADMAP Queue 1 item 7, part 2).
"""

from __future__ import annotations

import torch.distributed as dist


def axis_size(group=None) -> int:
    """The number of ranks in ``group``."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This process's rank in ``group``."""
    return dist.get_rank(group)
