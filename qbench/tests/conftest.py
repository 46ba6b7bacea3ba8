"""A cell of ``BENCHMARK.json`` cut to a size a test run holds: the
same files, with a tiny graph, model and batch."""

import copy

import pytest

from qbench import spec


def tiny(name: str, nodes: int = 5000):
    c = spec.cell(spec.load_benchmark(), name)
    cfg = copy.deepcopy(c.config)
    cfg["graph"]["nodes"] = nodes
    cfg["graph"]["degree"].update(median=8, max=300)
    cfg["features"].update(dim=16, classes=5)
    cfg["train_nodes"] = nodes // 5
    cfg["sizes"] = [4, 3, 2]
    cfg["model"]["hidden"] = 32
    traffic = dict(c.traffic, batch_size=64)
    if "keep_every" in traffic:
        traffic["keep_every"] = 2
    return c._replace(config=cfg, traffic=traffic)


@pytest.fixture
def tiny_cell():
    return tiny
