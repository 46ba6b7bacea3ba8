"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (used only for tensors on the CPU)."""

from . import _build, fused, gather, sample_kernel
from ._build import (ELEMS_LAUNCHES, LAUNCHES, PACKED_LAUNCHES, RAW_LAUNCHES,
                     reset_launches)
from .fused import (fused_hot_hop, fused_hot_hop_reference, fused_multihop,
                    fused_multihop_reference, fused_sample_hop,
                    fused_sample_multihop, multihop_plain)
from .gather import (gather_elems, gather_elems_plain, gather_rows,
                     gather_rows_plain, gather_rows_sharded,
                     gather_rows_sharded_plain, gather_segments,
                     gather_segments_plain)
from .sample_kernel import sample_layer_kernel, sample_layer_plain


def build_kernels() -> None:
    """Compile every kernel source at once, one ``nvcc`` each
    (``chip_smoke.py`` times this as set-up), and bind each library."""
    _build.build([fused._LIB, sample_kernel._LIB, gather._LIB])
    for mod in (fused, sample_kernel, gather):
        mod._lib()


__all__ = ["ELEMS_LAUNCHES", "LAUNCHES", "PACKED_LAUNCHES", "RAW_LAUNCHES",
           "build_kernels",
           "fused_hot_hop",
           "fused_hot_hop_reference", "fused_multihop",
           "fused_multihop_reference", "fused_sample_hop",
           "fused_sample_multihop", "gather_elems", "gather_elems_plain",
           "gather_rows", "gather_rows_plain", "gather_rows_sharded",
           "gather_rows_sharded_plain", "gather_segments",
           "gather_segments_plain", "multihop_plain", "reset_launches",
           "sample_layer_kernel", "sample_layer_plain"]
