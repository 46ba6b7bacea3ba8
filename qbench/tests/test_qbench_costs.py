"""The frozen byte and FLOP formulas against counts made by hand at a
tiny shape."""

import torch

from qbench.costs import flops, kernel_bytes, peaks


def test_gather_rows_bytes_by_hand():
    ids = torch.tensor([4, -1, 4, 9, 2])
    table, dev, distinct = kernel_bytes.gather_rows_bytes(ids, 108, 100)
    assert distinct == 3 and table == 3 * 108
    assert dev == 5 * 4 + 4 * 4 * 100


def test_sage_flops_by_hand():
    # one layer, 3 targets, 5 edges, 4 -> 2: two products 2*3*4*2 each,
    # the mean's sum 5*4 and division 3*4
    assert flops.sage_layer(3, 5, 4, 2) == 2 * (2 * 3 * 4 * 2) + 20 + 12
    fwd0, fwd1 = flops.sage_layer(3, 5, 4, 2), flops.sage_layer(1, 2, 2, 2)
    # backward: the first layer's products once (no input gradient), the
    # second's twice, each layer's sum over edges once more
    want = fwd0 + 2 * (2 * 3 * 4 * 2) + 5 * 4 \
        + fwd1 + 2 * 2 * (2 * 1 * 2 * 2) + 2 * 2
    assert flops.sage_step([(3, 6, 5), (1, 3, 2)], [4, 2, 2]) == want
    assert flops.sage_step([(3, 6, 5)], [4, 2], train=False) == fwd0


def test_peaks():
    assert peaks.matmul_peak(False) == 67e12
    assert peaks.matmul_peak(True) == 495e12
