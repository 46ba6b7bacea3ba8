from .sage_sampler import Adj, GraphSageSampler, SampleJob, layer_shapes

__all__ = ["Adj", "GraphSageSampler", "SampleJob", "layer_shapes"]
