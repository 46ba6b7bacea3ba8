from . import quant
from .sample import LayerSample, compact_ids, compact_layer, sample_layer

__all__ = ["quant", "LayerSample", "compact_ids", "compact_layer",
           "sample_layer"]
