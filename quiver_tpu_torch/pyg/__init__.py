from .sage_sampler import (Adj, GraphSageSampler, MixedGraphSageSampler,
                           SampleJob, layer_shapes)

__all__ = ["Adj", "GraphSageSampler", "MixedGraphSageSampler", "SampleJob",
           "layer_shapes"]
