"""On the card: the cells whose entry needs pinned host memory, sound
and with each fault planted; and every cell's control, which has to
come out as not correct. Run with ``python -m pytest qbench/tests -m
cuda`` on a machine with a card; elsewhere these skip."""

import pytest

from qbench import faults, run, spec

pytestmark = pytest.mark.cuda

PINNED = ["products_sage.serve_tiered"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", PINNED)
def test_sound_run_is_correct(card, tiny_cell, name):
    out = run.run_cell(tiny_cell(name), 2 ** 31 + 3, 0.5, False, card)
    assert out["correct"], out["checks"]


def _planted(names):
    """Each cell of ``names`` with each fault its driver can have."""
    bench = spec.load_benchmark()
    return [(n, f) for n in names
            for f in faults.DRIVER_FAULTS[spec.cell(bench, n).traffic[
                "driver"]]]


@pytest.mark.parametrize("name,fault", _planted(PINNED))
def test_fault_makes_the_run_incorrect(card, tiny_cell, name, fault):
    cell = tiny_cell(name)
    with faults.FAULTS[fault](cell.traffic["driver"]):
        out = run.run_cell(cell, 2 ** 31 + 17, 0.3, False, card)
    assert not out["correct"], out["checks"]


def _mid(name):
    """A cell at the configuration's widths on a graph of 50,000 nodes,
    which a test run holds."""
    c = spec.cell(spec.load_benchmark(), name)
    cfg = dict(c.config)
    cfg["graph"] = dict(cfg["graph"], nodes=50000)
    cfg["train_nodes"] = 10000
    return c._replace(config=cfg)


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_control_is_not_correct(card, name):
    from qbench.calibrate import _run
    cell = _mid(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        drv = _run(cell, seed, 0.5, card)
        r = drv.control_readings()
        limits = cell.limits["limits"]
        assert any(r[k] > limits[k] for k in r if k in limits), r
