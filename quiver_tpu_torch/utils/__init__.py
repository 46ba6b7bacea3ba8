from .csr import CSRTopo, get_csr_from_coo, index_dtype_for
from .device import resolve_device
from .reorder import reindex_by_config, reindex_feature
from .sizes import parse_size

__all__ = ["CSRTopo", "get_csr_from_coo", "index_dtype_for",
           "parse_size", "reindex_by_config", "reindex_feature",
           "resolve_device"]
