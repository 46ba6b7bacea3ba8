"""``ForkingPickler`` reducers for the port's stores (capability of JAX
``multiprocessing/reductions.py`` and the reference's
``reductions.py:5-33``)."""

from __future__ import annotations

from multiprocessing.reduction import ForkingPickler


def _rebuild_feature(handle):
    from ..feature import Feature
    return Feature.new_from_ipc_handle(handle[0], handle)


def _reduce_feature(feature):
    return _rebuild_feature, (feature.share_ipc(),)


def _rebuild_shard_tensor(state):
    from ..shard_tensor import ShardTensor
    return ShardTensor.from_ipc_state(state)


def _reduce_shard_tensor(st):
    return _rebuild_shard_tensor, (st.ipc_state(),)


def init_reductions():
    """Register the reducers: ``Feature`` through ``share_ipc`` /
    ``new_from_ipc_handle``, ``ShardTensor`` through its IPC state."""
    from ..feature import Feature
    from ..shard_tensor import ShardTensor
    ForkingPickler.register(Feature, _reduce_feature)
    ForkingPickler.register(ShardTensor, _reduce_shard_tensor)
