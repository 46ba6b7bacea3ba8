"""Sharing stores with ``torch.multiprocessing`` workers (counterpart of
``quiver_tpu/multiprocessing``; the reference's ``quiver.multiprocessing``).

Importing this package registers ``ForkingPickler`` reducers for
``Feature`` and ``ShardTensor`` (:func:`init_reductions`): a store sent
to a spawned worker, as an argument or through a queue, arrives with its
device tiers opened by CUDA IPC and its host tiers as shared memory
pinned again in the worker, without a copy of a row. Plain ``pickle`` is
unchanged: it copies the tiers through the CPU.
"""

import torch.multiprocessing  # noqa: F401  (torch's tensor reducers)

from .reductions import init_reductions

init_reductions()

__all__ = ["init_reductions"]
