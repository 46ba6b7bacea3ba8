"""The port's row gather (``quiver_tpu_torch/ops/kernels/gather.py``)
against the JAX package's Pallas kernel ``gather_rows``, run in
interpret mode as that package's tests run it. The port's wrapper gets
CPU tensors, so it runs the kernel's plain version; every output must
match bit for bit."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops.pallas import gather as jgather
from quiver_tpu_torch.ops.kernels import _build, gather

N = 300


def _ids(n=700):
    """700 ids (not a multiple of the Pallas kernel's 256-row block),
    with duplicates and both ends of the table."""
    ids = np.random.default_rng(3).integers(0, N, n).astype(np.int32)
    ids[:4] = [0, N - 1, 5, 5]
    return ids


def _jax_gather(feat, ids):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # JAX pads D to 128 lanes
        return jax.device_get(jgather.gather_rows(feat, jnp.asarray(ids),
                                                  interpret=True))


@pytest.mark.parametrize("dim", [12, 128])
def test_fp32_bit_exact(dim):
    feat = np.random.default_rng(dim).standard_normal((N, dim)) \
        .astype(np.float32)
    ids = _ids()
    want = np.asarray(_jax_gather(jnp.asarray(feat), ids))
    got = gather.gather_rows(torch.from_numpy(feat), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_bf16_bit_exact():
    feat = np.random.default_rng(4).standard_normal((N, 12)) \
        .astype(np.float32)
    ids = _ids()
    want = np.asarray(_jax_gather(jnp.asarray(feat, jnp.bfloat16), ids))
    tfeat = torch.from_numpy(feat).to(torch.bfloat16)
    got = gather.gather_rows(tfeat, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.view(torch.int16).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_other_dtypes_take_rows(dtype):
    g = np.random.default_rng(5)
    feat = torch.from_numpy(g.standard_normal((N, 7)).astype(np.float32)
                            * 20).to(dtype)
    ids = _ids(50)
    got = gather.gather_rows(feat, torch.from_numpy(ids))
    assert got.dtype == dtype
    assert torch.equal(got, feat[torch.from_numpy(ids).long()])


def test_int64_ids_are_cast():
    feat = torch.from_numpy(np.random.default_rng(6)
                            .standard_normal((N, 12)).astype(np.float32))
    ids = torch.from_numpy(_ids())
    assert torch.equal(gather.gather_rows(feat, ids.long()),
                       gather.gather_rows(feat, ids))


def test_no_ids_give_no_rows():
    feat = torch.zeros((N, 5))
    out = gather.gather_rows(feat, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 5) and out.dtype == torch.float32


def test_wrapper_refuses_what_the_kernel_does_not_take():
    feat = torch.zeros((N, 8))
    ids = torch.from_numpy(_ids(10))
    with pytest.raises(ValueError, match="fp32, bf16"):
        gather.gather_rows(feat.double(), ids)
    with pytest.raises(ValueError, match="contiguous 2-D"):
        gather.gather_rows(feat.t(), ids)
    with pytest.raises(ValueError, match="contiguous 2-D"):
        gather.gather_rows(feat[None], ids)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(feat, ids.float())
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(feat, ids.repeat(2)[::2])
    with pytest.raises(ValueError, match="on cpu"):      # devices differ
        gather.gather_rows(feat, ids.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather.gather_rows(feat.to("meta"), ids.to("meta"))


def test_cpu_tensors_take_the_plain_version():
    _build.reset_launches()
    gather.gather_rows(torch.zeros((N, 4)), torch.from_numpy(_ids(10)))
    assert _build.LAUNCHES["gather_rows"] == 0
