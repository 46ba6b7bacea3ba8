"""A run's check comes out false when the timed path is broken
underneath: each fault of ``qbench/faults.py`` planted in the program,
the rest of a run driven as the benchmark drives it (without its look
for a card), on the CPU at a tiny size. The cells whose entry needs
pinned host memory run these on the card (``test_qbench_card.py``)."""

import pytest

from qbench import faults, run, spec

TRAIN = ["products_sage_weighted.train_gpu"]


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(tiny_cell, name):
    out = run.run_cell(tiny_cell(name), 2 ** 31 + 5, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in TRAIN for f in faults.DRIVER_FAULTS[spec.cell(
        spec.load_benchmark(), n).traffic["driver"]]])
def test_fault_makes_the_run_incorrect(tiny_cell, name, fault):
    cell = tiny_cell(name)
    with faults.FAULTS[fault](cell.traffic["driver"]):
        out = run.run_cell(cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert not out["correct"], out["checks"]


def test_state_left_unchanged_reads_one():
    """A step that leaves the parameters as they were gives each moving
    leaf a change of norm 0, a gap of 1 against the reference."""
    import torch

    from qbench.reference import judge
    ref = {"w": torch.ones(3), "b": torch.ones(2)}
    r = judge.leaf_gap({"w": torch.zeros(3), "b": torch.zeros(2)}, ref)
    assert r == 1.0
