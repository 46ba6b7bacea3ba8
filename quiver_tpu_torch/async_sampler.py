"""Per-layer sampler with explicit sample and reindex steps, and
sample-ahead pipelining (counterpart of ``quiver_tpu/async_sampler.py``).

``AsyncNeighborSampler`` (alias ``AsyncCudaNeighborSampler``) is the
reference's legacy per-layer API: the caller drives ``sample_layer`` and
``reindex`` itself. Its work is queued on the card like every torch
call, and read only when used.

:func:`sample_ahead` runs ``sampler.sample`` one batch ahead on a
bounded :class:`~quiver_tpu_torch.pipeline.Pipeline` and publishes each
batch's frontier through ``feature.stage_frontier``.
"""

from __future__ import annotations

import torch

from .ops.sample import compact_layer, sample_layer
from .pipeline import Pipeline
from .utils.device import resolve_device


class AsyncNeighborSampler:
    """``sample_layer(batch, size) -> (neighbours [bs, size] -1 fill,
    counts [bs])`` and ``reindex(inputs, outputs) -> (n_id, row, col)``
    over a ``CSRTopo`` on ``device`` (the card unless ``"cpu"``), drawing
    from one ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, csr_topo, device=None, seed: int = 0):
        self.csr_topo = csr_topo
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(seed)
        self._indptr = csr_topo.indptr.to(self.device)
        self._indices = csr_topo.indices.to(self.device)

    def sample_layer(self, batch, size: int):
        seeds = torch.as_tensor(batch).to(self.device, torch.int32)
        return sample_layer(self._indptr, self._indices, seeds, int(size),
                            self.generator)

    def reindex(self, inputs, outputs, counts=None):
        """The layer's bipartite graph compacted: ``(n_id, row, col)``."""
        layer = compact_layer(
            torch.as_tensor(inputs).to(self.device, torch.int32),
            torch.as_tensor(outputs).to(self.device, torch.int32))
        return layer.n_id, layer.row, layer.col


def sample_ahead(sampler, seed_batches, feature=None, depth: int = 2):
    """Yield ``sampler.sample(seeds)`` for each of ``seed_batches`` in
    order, sampling up to ``depth`` batches ahead on a pipeline worker:
    while the caller consumes batch i, batch i+1 samples. With
    ``feature``, each batch's frontier (``n_id``) is published through
    ``feature.stage_frontier`` on the worker as soon as it exists (the
    cold-tier prefetch; a store without a disk tier returns None there).

    The worker is the only caller of ``sampler.sample``, so the sampler's
    generator is drawn in the same order as by a serial loop, and the
    batches are those of the serial loop. On the card the worker's
    launches go to the default stream, which the caller's work follows.
    The pipeline closes when the generator finishes, fails or is
    abandoned."""
    pipe = Pipeline(depth=depth, name="quiver-sample-ahead")

    def _stage(seeds):
        out = sampler.sample(seeds)
        if feature is not None:
            feature.stage_frontier(out[0])
        return out

    try:
        yield from pipe.map(_stage, seed_batches)
    finally:
        pipe.close()


# the reference's name
AsyncCudaNeighborSampler = AsyncNeighborSampler
