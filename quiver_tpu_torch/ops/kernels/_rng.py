"""The kernels' counter-hash PRNG, in plain PyTorch.

Counterpart of the ``"hash"`` branch of ``make_rand_bits`` and of
``_mix_u32`` in ``quiver_tpu/ops/pallas/_dma.py``. The CUDA kernels in
``csrc/fused_hop.cu`` compute the same bits in ``uint32_t``; this copy
is their plain version. torch's uint32 support is partial, so the
arithmetic runs in int64 and is cut to 32 bits after every multiply.

Seeds are numbered as in the kernels: a 128-seed block ``blk`` and a
``lane`` inside it, so seed ``s`` has ``blk = s // 128`` and
``lane = s % 128``. Draw number ``step`` of a lane is
``mix(mix(base ^ lane*0x85EBCA6B ^ step*0x9E3779B9))`` with
``base = mix(seed ^ 0x9E3779B9*(blk+1))``, all modulo 2**32.
"""

from __future__ import annotations

import torch

BLOCK = 128
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_LANE_SALT = 0x85EBCA6B


def mix_u32(x: torch.Tensor) -> torch.Tensor:
    """Wang-style 32-bit finalizer on int64 tensors holding uint32 values."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    return x ^ (x >> 15)


def block_base(seed: int, blk: torch.Tensor) -> torch.Tensor:
    """Per-block stream base; ``seed`` is an int32 (two's complement)."""
    return mix_u32((seed & _M32) ^ ((_GOLDEN * (blk + 1)) & _M32))


def rand_bits(base: torch.Tensor, lane: torch.Tensor,
              step: int) -> torch.Tensor:
    """Draw number ``step``: uint32 values held in int64."""
    x = base ^ ((lane * _LANE_SALT) & _M32) ^ ((step * _GOLDEN) & _M32)
    return mix_u32(mix_u32(x))

