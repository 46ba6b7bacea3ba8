"""Meshes and the group the multi-rank steps run over (counterpart of
``quiver_tpu/parallel/mesh.py``).

One process over several devices, as a JAX ``Mesh`` gives it:
:func:`make_mesh` returns a :class:`Mesh`, an array of ``torch.device``s
with named axes (every visible card by default), and :func:`replicated`
and :func:`row_sharded` the placements ``Feature`` reads from it:

- ``data``  : data parallelism (per-device seed batches; gradients
  averaged)
- ``cache`` : the feature store's row sharding (the p2p clique)

A device may appear more than once: on one card a mesh of four entries
gives four shards, each its own allocation, read by the same kernel as
four peers would be (JAX's tests run their mesh on virtual CPU devices
the same way). On the CPU every entry is ``cpu``.

Across processes the parallelism is a ``torch.distributed`` process
group, one process per rank (None = the default group): ``axis_size``
and ``axis_index`` are the group's counterparts of ``mesh.shape[axis]``
and ``lax.axis_index(axis)``, and ``parallel/gspmd.py`` takes a 2-D
``torch.distributed.device_mesh.DeviceMesh``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """``devices`` (an object ndarray of ``torch.device``) with one name
    per axis; ``shape`` maps each name to its size, as JAX's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for at, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[at] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


class MeshPlacement(NamedTuple):
    """A placement over a mesh: ``axis`` None for replicated, else the
    mesh axis the rows are split over."""

    mesh: Mesh
    axis: Optional[str]


def _visible() -> list:
    if torch.cuda.is_available() and torch.cuda.device_count():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over ``devices`` (every visible card by default, else the
    CPU), reshaped to ``shape`` (default: all of them on the first
    axis)."""
    devices = list(devices if devices is not None else _visible())
    if shape is None:
        shape = [len(devices)] + [1] * (len(axis_names) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def replicated(mesh: Mesh) -> MeshPlacement:
    return MeshPlacement(mesh, None)


def row_sharded(mesh: Mesh, axis: str) -> MeshPlacement:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} ({mesh.axis_names})")
    return MeshPlacement(mesh, axis)


def axis_size(group=None) -> int:
    """The number of ranks in ``group``."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This process's rank in ``group``."""
    return dist.get_rank(group)
