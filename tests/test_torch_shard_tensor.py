"""The port's ``ShardTensor`` (``quiver_tpu_torch/shard_tensor.py``)
against the JAX package's (``quiver_tpu/shard_tensor.py``), on the CPU.

Device and host shards interleave; lookups take valid ids from every
shard, -1 and ids past the end (zero rows), in fp32, bf16 and int8
policies. fp32 and bf16 lookups equal JAX's bit for bit. For int8 the
stored codes and sidecars equal JAX's bit for bit; the device group's
rows equal JAX's (both round the multiply, then the add), and the host
group's rows equal JAX's stored host tier decoded with those two
roundings, while JAX's own host decode (through float64, one rounding)
is within one rounding of them (``ONE_ROUNDING``). The shape protocol,
``device_tensor_list``, ``cpu_tensor`` and ``share_ipc`` round trips
follow JAX's.

The JAX store keeps one group per device, and on the tests' eight
virtual CPU devices a lookup across two device groups fails there; so
its device shards all go to device 0, while the port's go to devices 0
and 1: each append is one block of the port's one gather, wherever it
lies (three device groups: ``tests/test_torch_clique.py``)."""

import numpy as np
import pytest
import torch

from quiver_tpu import ShardTensor as JShardTensor
from quiver_tpu import ShardTensorConfig as JConfig
from quiver_tpu_torch import ShardTensor, ShardTensorConfig
from quiver_tpu_torch.ops import quant

DIM = 7
# (rows, device) of each append: device shards 0 and 1 (one group on one
# card), host shards -1
LAYOUT = [(30, 0), (25, -1), (20, 1), (15, -1)]
ONE_ROUNDING = 2.0 ** -20


def _blocks(seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal((r, DIM)).astype(np.float32) * 3
            for r, _ in LAYOUT]


def _pair(policy, layout=LAYOUT, blocks=None):
    blocks = _blocks() if blocks is None else blocks
    j = JShardTensor(0, JConfig({0: "1M"}), dtype_policy=policy)
    t = ShardTensor(0, ShardTensorConfig({0: "1M"}), dtype_policy=policy,
                    device="cpu")
    for b, (_, dev) in zip(blocks, layout):
        j.append(b, min(dev, 0))
        t.append(torch.from_numpy(b) if dev >= 0 else b, dev)
    return j, t


def _ids():
    total = sum(r for r, _ in LAYOUT)
    g = np.random.default_rng(7)
    ids = g.integers(0, total, 120).astype(np.int64)
    ids[::9] = -1
    ids[5::13] = total + 3
    return ids


def _bits(a):
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().view(np.uint8)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return np.ascontiguousarray(a).view(np.uint8)


def _host_rows(ids):
    """Which ids land in a host shard."""
    starts = np.cumsum([0] + [r for r, _ in LAYOUT])
    out = np.zeros(ids.shape, bool)
    for (r, dev), s in zip(LAYOUT, starts):
        if dev < 0:
            out |= (ids >= s) & (ids < s + r)
    return out


@pytest.mark.parametrize("policy", [None, "bf16"])
def test_lookup_equals_jax(policy):
    j, t = _pair(policy)
    ids = _ids()
    got, want = t[ids], np.asarray(j[ids])
    assert got.shape == want.shape == (ids.shape[0], DIM)
    assert np.array_equal(_bits(got), _bits(want))
    assert not got[(ids < 0) | (ids >= t.size(0))].any()
    assert np.array_equal(_bits(t[torch.from_numpy(ids).int()]), _bits(got))


def test_int8_lookup_against_jax():
    j, t = _pair("int8")
    # the stored codes and sidecars of the device and host shards are
    # JAX's device group and host group
    for ours, theirs in zip(t.stored(host=False), j._dev_data[0]):
        assert np.array_equal(_bits(ours), _bits(theirs))
    for ours, theirs in zip(t.stored(host=True), j._host_data):
        assert np.array_equal(_bits(ours), _bits(theirs))
    ids = _ids()
    got, want = t[ids].numpy(), np.asarray(j[ids])
    host = _host_rows(ids)
    assert np.array_equal(_bits(got[~host]), _bits(want[~host]))
    # the host group against JAX's stored tier, decoded with two roundings
    hq = j._host_data
    decoded = hq.data.astype(np.float32) * hq.scale + hq.zero
    local = np.asarray([_local(i) for i in ids[host]])
    assert np.array_equal(_bits(got[host]), _bits(decoded[local]))
    np.testing.assert_allclose(got[host], want[host], rtol=0,
                               atol=ONE_ROUNDING)


def _local(i):
    """The host-group row of logical id ``i``."""
    base = 0
    start = 0
    for r, dev in LAYOUT:
        if dev < 0 and start <= i < start + r:
            return base + i - start
        if dev < 0:
            base += r
        start += r
    raise AssertionError(i)


@pytest.mark.parametrize("layout", [[(40, 0)], [(40, -1)], [(10, -1), (30, 0)],
                                    [(20, 0), (0, -1), (20, 0)]], ids=str)
def test_single_group_and_empty_shards(layout):
    blocks = [np.random.default_rng(i).standard_normal((r, DIM))
              .astype(np.float32) for i, (r, _) in enumerate(layout)]
    j, t = _pair(None, layout, blocks)
    ids = np.array([-1, 0, 5, 19, 20, 21, 39, 40, 100], np.int64)
    assert np.array_equal(_bits(t[ids]), _bits(np.asarray(j[ids])))


@pytest.mark.parametrize("policy", [None, "bf16", "int8"])
def test_shape_protocol_and_sharing(policy):
    j, t = _pair(policy)
    assert t.shape == j.shape == (90, DIM) and t.size(0) == 90
    assert t.size(1) == DIM
    tl, jl = t.device_tensor_list, j.device_tensor_list
    assert len(tl) == len(jl) == 2
    for a, b in zip(tl, jl):
        assert np.array_equal(_bits(a), _bits(b))
    cpu = t.cpu_tensor
    assert cpu.device.type == "cpu" and cpu.shape == (40, DIM)
    if policy != "int8":
        assert np.array_equal(_bits(cpu), _bits(j.cpu_tensor))
    cpu.zero_()                              # a copy: the store is intact
    assert t[np.array([30])].abs().sum() > 0
    handle = t.share_ipc()
    assert handle[1] == quant.resolve_policy(policy)
    u = ShardTensor.new_from_share_ipc(handle, device="cpu")
    ids = _ids()
    assert u.shape == t.shape and u.dtype_policy == t.dtype_policy
    if policy is None:
        assert np.array_equal(_bits(u[ids]), _bits(t[ids]))
    else:                   # values re-quantized: close, not the same codes
        np.testing.assert_allclose(u[ids].float(), t[ids].float(),
                                   atol=0.1, rtol=0.02)
    # handles without a policy: a bare item list
    v = ShardTensor.new_from_share_ipc(handle[0], device="cpu")
    assert v.dtype_policy is None and v.shape == t.shape
    assert ShardTensorConfig({0: "2M", 1: 7}).device_list == [0, 1]
    assert ShardTensorConfig({0: "2M"}).budget_bytes(0) \
        == JConfig({0: "2M"}).budget_bytes(0)


def test_append_errors_match_jax():
    j, t = _pair(None)
    for bad, match in ((np.zeros((3, DIM + 1), np.float32), "dim"),
                       (np.zeros((3, DIM), np.float64), "dtype"),
                       (np.zeros((3,), np.float32), "2-D")):
        with pytest.raises(ValueError, match=match):
            t.append(bad, -1)
        with pytest.raises(ValueError, match=match):
            j.append(bad, -1)
    with pytest.raises(ValueError, match="empty"):
        ShardTensor(device="cpu")[np.array([0])]
    with pytest.raises(ValueError, match="empty"):
        JShardTensor()[np.array([0])]
