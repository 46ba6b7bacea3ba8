"""The one traffic generator: the inputs of every timed unit, drawn
from the run's seed and the traffic mix's parameters.

A unit is one train step, one sampled batch or one served batch. Its
node ids come from a pool (``"train_set"``, or ``"all_nodes"``) in
epochs: each epoch is a permutation of the pool drawn on the device
from ``(seed, epoch)``, cut into whole batches in order, so the ids of
one batch are distinct. Its integers (the kernels' per-hop seeds, a
dropout seed) come from a host generator keyed by ``(seed, unit)``.
Every seed gives the same sizes; only the ids differ.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _key(seed: int, *tags: int) -> int:
    """A 63-bit integer drawn from ``(seed, *tags)``."""
    return int(np.random.default_rng([seed % 2 ** 63, *tags]).integers(
        0, 2 ** 63))


class Feed:
    def __init__(self, pool: torch.Tensor, batch: int, seed: int):
        self.pool = pool
        self.batch = int(batch)
        self.seed = int(seed)
        self.per_epoch = pool.shape[0] // self.batch
        if self.per_epoch < 1:
            raise ValueError("the pool holds less than one batch")
        self._epoch, self._perm = -1, None

    def ids(self, unit: int) -> torch.Tensor:
        """Unit ``unit``'s ``[batch]`` int32 ids on the pool's device."""
        epoch, j = divmod(int(unit), self.per_epoch)
        if epoch != self._epoch:
            gen = torch.Generator(device=self.pool.device).manual_seed(
                _key(self.seed, 1, epoch))
            order = torch.randperm(self.pool.shape[0], generator=gen,
                                   device=self.pool.device)
            self._perm = self.pool[order]
            self._epoch = epoch
        return self._perm[j * self.batch:(j + 1) * self.batch]

    def ints(self, unit: int, n: int) -> List[int]:
        """Unit ``unit``'s ``n`` int32 values."""
        rng = np.random.default_rng([self.seed % 2 ** 63, 2, int(unit)])
        return [int(v) for v in rng.integers(-2 ** 31, 2 ** 31, n)]

    def key(self, *tags: int) -> int:
        """A 63-bit integer for the run's other draws."""
        return _key(self.seed, 3, *tags)

    def keep(self, unit: int, every: int) -> bool:
        """Whether unit ``unit`` is among the checked sample: one unit
        in ``every``, at an offset drawn from the seed."""
        return int(unit) % every == _key(self.seed, 4) % every
