"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and of its host link."""

HBM_BYTES_PER_S = 3.35e12        # HBM3
FP32_FLOPS = 67e12               # float32 outside the tensor cores
TF32_FLOPS = 495e12              # TF32 tensor cores, dense
PCIE_BYTES_PER_S = 64e9          # PCIe Gen5 x16, one direction


def matmul_peak(tf32: bool) -> float:
    """The peak of the precision the fp32 matmuls run in."""
    return TF32_FLOPS if tf32 else FP32_FLOPS
