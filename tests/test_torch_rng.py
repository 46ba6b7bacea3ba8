"""The port's counter-hash PRNG against the JAX package's ``"hash"``
backend (``quiver_tpu/ops/pallas/_dma.py``): bit-exact draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops.pallas import _dma
from quiver_tpu_torch.ops.kernels import _rng


@pytest.mark.parametrize("seed", [0, 7, -1, -123456789, 2**31 - 1, -2**31])
@pytest.mark.parametrize("blk", [0, 1, 37])
def test_draws_bit_exact(seed, blk):
    draw = _dma.make_rand_bits("hash", jnp.int32(seed), jnp.int32(blk))
    base = _rng.block_base(seed, torch.tensor(blk, dtype=torch.int64))
    lane = torch.arange(_rng.BLOCK, dtype=torch.int64)
    for step in range(5):
        want = np.asarray(draw(_rng.BLOCK)).astype(np.int64)
        got = _rng.rand_bits(base, lane, step).numpy()
        np.testing.assert_array_equal(got, want)


def test_mix_bit_exact(rng):
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(_dma._mix_u32(jnp.asarray(x))).astype(np.int64)
    got = _rng.mix_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)

