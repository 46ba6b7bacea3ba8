from .convert import (flax_to_state_dict, gat_flax_to_state_dict,
                      gat_state_dict_to_flax, random_gat_flax_params,
                      state_dict_to_flax)
from .gat import GAT, GATConv, segment_softmax
from .sage import GraphSAGE, SAGEConv, masked_mean_aggregate

__all__ = ["GAT", "GATConv", "GraphSAGE", "SAGEConv",
           "flax_to_state_dict", "gat_flax_to_state_dict",
           "gat_state_dict_to_flax", "masked_mean_aggregate",
           "random_gat_flax_params", "segment_softmax",
           "state_dict_to_flax"]
