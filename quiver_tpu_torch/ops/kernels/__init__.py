"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (used only for tensors on the CPU)."""

from .fused import (LAUNCHES, build_kernels, fused_hot_hop,
                    fused_multihop, fused_multihop_reference,
                    fused_sample_hop, fused_sample_multihop,
                    reset_launches)

__all__ = ["LAUNCHES", "build_kernels", "fused_hot_hop", "fused_multihop",
           "fused_multihop_reference", "fused_sample_hop",
           "fused_sample_multihop", "reset_launches"]
