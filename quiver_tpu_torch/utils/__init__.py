from .csr import CSRTopo, get_csr_from_coo, index_dtype_for
from .device import resolve_device
from .reorder import reindex_by_config, reindex_feature
from .sizes import UNITS, parse_size
from .topo import Topo, init_p2p

__all__ = ["CSRTopo", "Topo", "UNITS", "init_p2p", "get_csr_from_coo", "index_dtype_for",
           "parse_size", "reindex_by_config", "reindex_feature",
           "resolve_device"]
