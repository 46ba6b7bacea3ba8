"""What the drivers share: the inputs made from the seed, the program's
training outputs read back, and the window's sampled checks."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from .. import data
from ..feed import Feed


class Driver:
    """A cell's driver. ``setup`` does everything before the first timed
    unit, ``unit(i)`` runs timed unit ``i`` (``first_unit`` on), and
    ``end_to_end(units, seconds)`` gives the end-to-end metrics of the
    window. After ``release`` has freed the program's state,
    ``readings`` holds the program's outputs to the reference and
    ``control_readings`` the reference computed in the precision below
    the configuration's in the program's place. ``trace_facts(units)``
    gives the metric readers what the traced units needed (bytes,
    FLOPs, span times)."""

    first_unit = 0
    tracing = False     # set while the traced units run

    def __init__(self, cell, seed: int, dev):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.dev = torch.device(dev)
        self.gen = torch.Generator(device=self.dev).manual_seed(
            self.seed % 2 ** 63)
        self.traced = []    # what the traced units leave for their facts

    # the inputs, drawn in one fixed order from the run's generator
    def make_graph(self):
        self.graph = data.make_graph(self.cfg, self.gen, self.dev)
        return self.graph

    def make_features(self):
        self.feat, self.labels = data.make_features(
            self.cfg, self.gen, self.dev, self.graph.nodes)

    def make_pool(self) -> torch.Tensor:
        """The ids the traffic's batches come from: ``"train_set"``, the
        train split drawn from the seed, or ``"all_nodes"``."""
        pool = self.traffic["pool"]
        if pool == "train_set":
            return data.make_train_set(self.cfg, self.gen, self.dev,
                                       self.graph.nodes)
        if pool == "all_nodes":
            return torch.arange(self.graph.nodes, dtype=torch.int32,
                                device=self.dev)
        raise ValueError(f"unknown pool {pool!r}")

    def make_feed(self, batch: int):
        self.feed = Feed(self.make_pool(), batch, self.seed)
        return self.feed

    def make_params(self, model) -> Dict[str, torch.Tensor]:
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.params0 = data.make_params(shapes, self.gen, self.dev)
        return self.params0

    def trace_facts(self, units) -> dict:
        return {}

    def control_readings(self) -> dict:
        raise NotImplementedError


def optimizer_grads(model, opt) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer got it, worked out
    from its state after that step: Adam's first moment divided by
    ``1 - beta1``."""
    b1 = opt.param_groups[0]["betas"][0]
    return {n: opt.state[p]["exp_avg"].detach() / (1 - b1)
            for n, p in model.named_parameters()}


def params_of(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def frontier_caps(batch: int, sizes):
    """Each hop's static target count, then the last frontier's."""
    caps = [int(batch)]
    for k in sizes:
        caps.append(caps[-1] * (1 + int(k)))
    return caps


@contextlib.contextmanager
def tf32(on: bool):
    """fp32 matmuls in TF32 (``on``) or in full fp32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old



def adj_block_sizes(edge_indices, batch: int):
    """Each block's valid ``(targets, sources, edges)``, outermost
    first, from the edge lists in sampling order (``[2, E]`` source
    slot, target slot; -1 on padded edges): hop ``h``'s targets are the
    valid frontier before it, its sources the frontier after it."""
    out, v = [], int(batch)
    for ei in edge_indices:
        live = ei[0] >= 0
        e = int(live.sum())
        nxt = max(v, int(ei[0][live].max()) + 1) if e else v
        out.append((v, nxt, e))
        v = nxt
    return out[::-1]


def sync(dev) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
