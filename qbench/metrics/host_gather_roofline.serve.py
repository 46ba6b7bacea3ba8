"""The host-tier gather (``gather_rows_packed_kernel``) against its
bound: each distinct cold row of the traced batches' frontiers read
once from pinned host memory at PCIe Gen5 x16's published rate, or the
ids read and the fp32 rows written at the card's HBM rate, whichever
takes longer; over the kernel's summed device time."""

from qbench.costs import peaks


def read(s):
    t = s.kernel_seconds("gather_rows_packed_kernel")
    host = s.facts.get("host_gather_host_bytes")
    if t <= 0 or not host:
        return None
    bound = max(host / peaks.PCIE_BYTES_PER_S,
                s.facts["host_gather_device_bytes"] / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / t
