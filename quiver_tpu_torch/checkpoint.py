"""Checkpoint and resume (counterpart of ``quiver_tpu/checkpoint.py``).

:func:`save_state` and :func:`restore_state` keep a
``parallel.train.TrainState``: the model's and the optimizer's
``state_dict`` and the step count, written with ``torch.save`` and read
with ``torch.load(weights_only=True)``. The JAX package writes orbax
checkpoints; their on-disk layout is not reproduced, so neither package
restores the other's train state.

:func:`save_artifact` and :func:`load_artifact` keep preprocessing
products (partition books, cache orders, hot permutations) in the JAX
package's ``.npz`` format exactly, so either package reads the other's
files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

_STATE_FILE = "state.pt"


def _target(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return os.path.join(path, str(step)) if step is not None else path


def save_state(path: str, state, step: Optional[int] = None,
               force: bool = True) -> str:
    """Write ``state`` (a ``TrainState``) under ``path`` (in the
    subdirectory ``step`` when given). ``force=False`` refuses to replace
    an existing checkpoint. The file is written whole under a temporary
    name and renamed into place. Returns ``path``, absolute."""
    target = _target(path, step)
    file = os.path.join(target, _STATE_FILE)
    if not force and os.path.exists(file):
        raise FileExistsError(f"{file} exists; pass force=True to replace it")
    os.makedirs(target, exist_ok=True)
    tmp = f"{file}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, file)
    return os.path.abspath(path)


def restore_state(path: str, example, step: Optional[int] = None):
    """The ``TrainState`` saved under ``path`` (and ``step``): its
    parameters and optimizer moments loaded into ``example``'s model and
    optimizer (which supply the structure, shapes and devices), with the
    saved step count."""
    file = os.path.join(_target(path, step), _STATE_FILE)
    # read on the host: load_state_dict copies each tensor to its
    # parameter's device (and keeps Adam's step counts on the host)
    saved = torch.load(file, map_location="cpu", weights_only=True)
    example.model.load_state_dict(saved["model"])
    example.optimizer.load_state_dict(saved["optimizer"])
    return type(example)(example.model, example.optimizer, saved["step"])


def save_artifact(path: str, **arrays) -> str:
    """Preprocessing artifacts as one ``.npz`` (tensors go through numpy
    on the host)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() if torch.is_tensor(v)
                      else np.asarray(v) for k, v in arrays.items()})
    return path


def load_artifact(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
