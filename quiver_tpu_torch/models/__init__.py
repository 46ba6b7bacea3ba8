from .convert import flax_to_state_dict, state_dict_to_flax
from .sage import GraphSAGE, SAGEConv, masked_mean_aggregate

__all__ = ["GraphSAGE", "SAGEConv", "masked_mean_aggregate",
           "flax_to_state_dict", "state_dict_to_flax"]
