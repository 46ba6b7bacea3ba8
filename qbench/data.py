"""The inputs of a run, made on the device from the run's seed.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
every input in a fixed order, in a few large calls: the degrees, the
neighbour lists, the labels and features, the train split, the edge
weights and the model's initial weights. The same seed gives the same
inputs. The program and the reference are handed the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class Graph:
    """A CSR graph: ``indptr`` [n + 1] and ``indices`` [E], both int32,
    and ``deg`` [n] int64."""

    def __init__(self, indptr, indices, deg):
        self.indptr, self.indices, self.deg = indptr, indices, deg

    @property
    def nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def edges(self) -> int:
        return int(self.indices.shape[0])


def make_graph(cfg: dict, gen: torch.Generator, dev) -> Graph:
    """Lognormal degrees (the configuration's median, sigma and
    maximum) and neighbours drawn uniformly over all nodes."""
    g = cfg["graph"]
    law = g["degree"]
    n = int(g["nodes"])
    ln = torch.randn(n, generator=gen, device=dev) * float(law["sigma"]) \
        + math.log(float(law["median"]))
    deg = torch.exp(ln).to(torch.int64).clamp_(0, int(law["max"]))
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    e = int(indptr[-1])
    if e >= 2 ** 31:
        raise ValueError(f"{e} edges do not fit int32 offsets")
    indices = torch.randint(0, n, (e,), generator=gen, device=dev,
                            dtype=torch.int32)
    return Graph(indptr.to(torch.int32), indices, deg)


def make_features(cfg: dict, gen: torch.Generator, dev, n: int):
    """``(feat [n, dim] fp32, labels [n] int32)``: each node's class
    centre plus noise, as the repository's synthetic products example
    makes them."""
    f = cfg["features"]
    classes, dim = int(f["classes"]), int(f["dim"])
    labels = torch.randint(0, classes, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    centers = torch.randn(classes, dim, generator=gen, device=dev)
    feat = torch.randn(n, dim, generator=gen, device=dev)
    feat.mul_(float(f["noise"])).add_(centers[labels.long()])
    return feat, labels


def make_train_set(cfg: dict, gen: torch.Generator, dev, n: int):
    """The train split: ``train_nodes`` distinct ids, int32."""
    return torch.randperm(n, generator=gen, device=dev)[
        :int(cfg["train_nodes"])].to(torch.int32)


def make_edge_weights(cfg: dict, gen: torch.Generator, dev, e: int):
    """Positive lognormal weights, one per CSR slot, fp32."""
    sigma = float(cfg["edge_weight"]["sigma"])
    return torch.randn(e, generator=gen, device=dev).mul_(sigma).exp_()


def make_params(shapes: Dict[str, tuple], gen: torch.Generator,
                dev) -> Dict[str, torch.Tensor]:
    """Initial weights for the named parameter shapes, in one draw: a
    matrix ``[out, in]`` is normal with variance ``1 / in``, a bias is
    zero, an attention vector ``[heads, width]`` is normal with variance
    ``2 / (heads + width)``."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=dev)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        t = z[at:at + size].reshape(shape).clone()
        at += size
        if name.endswith("bias"):
            t.zero_()
        elif "att_" in name:
            t.mul_(math.sqrt(2.0 / (shape[0] + shape[1])))
        else:
            t.mul_(1.0 / math.sqrt(shape[-1]))
        out[name] = t
    return out
