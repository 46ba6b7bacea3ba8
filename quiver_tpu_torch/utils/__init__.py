from .csr import CSRTopo, get_csr_from_coo, index_dtype_for
from .device import resolve_device

__all__ = ["CSRTopo", "get_csr_from_coo", "index_dtype_for",
           "resolve_device"]
