"""Faults planted in the program's timed path, for the tests that show a
run's check comes out false, and for the readings that set the upper
end of each limit. Each is a context manager that patches one function
of ``quiver_tpu_torch`` while it is open.

- ``half_batch``: the train loss is the mean over the first half of the
  batch only; a served or sampled batch loses its second half of ids.
- ``answer``: a sampling hop's first pick of every seed is replaced by
  the seed itself, where the picks are produced.
- ``uniform_draw``: the weighted draw ignores the edge weights (every
  weight 1), so it draws uniformly over the pool (weighted cells only).
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(owner, name: str, make):
    """``owner.name`` (``owner`` a module's dotted name, or an object)
    replaced by ``make(old)`` while the block runs."""
    if isinstance(owner, str):
        owner = importlib.import_module(owner)
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _half_loss(old):
    def loss(logits, labels):
        n = logits.shape[0] // 2
        return old(logits[:n], labels[:n])
    return loss


def _half_ids(old):
    def fn(self, node_ids, *args, **kwargs):
        ids = old(self, node_ids, *args, **kwargs)
        ids = ids.clone()
        ids[ids.shape[0] // 2:] = -1
        return ids
    return fn


def _unit_weights(old):
    def fn(indptr, indices, weights, *args, **kwargs):
        return old(indptr, indices, torch.ones_like(weights), *args,
                   **kwargs)
    return fn


def _self_pick_at(at: int):
    """A sampler whose first pick of every seed is the seed itself;
    its seeds are argument ``at``."""
    def make(old):
        def fn(*args, **kwargs):
            out = old(*args, **kwargs)
            seeds = args[at]
            nbrs = out[0].clone()
            first = nbrs[:, 0]
            nbrs[:, 0] = first.where(first < 0, seeds.to(first.dtype))
            return (nbrs,) + tuple(out[1:])
        return fn
    return make


def half_batch(driver: str):
    if driver == "train_split":
        return _patched("quiver_tpu_torch.parallel.train",
                        "cross_entropy_logits", _half_loss)
    import quiver_tpu_torch.serving as s
    return _patched(s.ServeEngine, "pad_seeds", _half_ids)


def answer(driver: str):
    if driver == "serve":
        return _patched("quiver_tpu_torch.ops.kernels.fused",
                        "fused_sample_hop", _self_pick_at(2))
    return _patched("quiver_tpu_torch.ops.sample_multihop",
                    "sample_layer_weighted", _self_pick_at(3))


def uniform_draw(driver: str):
    return _patched("quiver_tpu_torch.ops.sample_multihop",
                    "sample_layer_weighted", _unit_weights)


FAULTS = {"half_batch": half_batch, "answer": answer,
          "uniform_draw": uniform_draw}

# the faults each driver's cells can have
DRIVER_FAULTS = {"train_split": ("half_batch", "answer", "uniform_draw"),
                 "serve": ("half_batch", "answer")}
