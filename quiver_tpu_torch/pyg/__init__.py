from .sage_sampler import Adj, layer_shapes

__all__ = ["Adj", "layer_shapes"]
