from .convert import (flax_to_state_dict, gat_flax_to_state_dict,
                      gat_state_dict_to_flax, mag_flax_to_state_dict,
                      mag_state_dict_to_flax, random_gat_flax_params,
                      random_mag_flax_params, random_rgcn_flax_params,
                      rgcn_flax_to_state_dict, rgcn_state_dict_to_flax,
                      state_dict_to_flax)
from .gat import GAT, GATConv, segment_softmax
from .mag import MAG240MGNN
from .rgcn import RGCN, RGCNConv
from .sage import GraphSAGE, SAGEConv, masked_mean_aggregate

__all__ = ["GAT", "GATConv", "GraphSAGE", "MAG240MGNN", "RGCN", "RGCNConv",
           "SAGEConv", "flax_to_state_dict", "gat_flax_to_state_dict",
           "gat_state_dict_to_flax", "mag_flax_to_state_dict",
           "mag_state_dict_to_flax", "masked_mean_aggregate",
           "random_gat_flax_params", "random_mag_flax_params",
           "random_rgcn_flax_params", "rgcn_flax_to_state_dict",
           "rgcn_state_dict_to_flax", "segment_softmax",
           "state_dict_to_flax"]
