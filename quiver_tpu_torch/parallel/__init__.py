from .serve_ops import layers_to_adjs, masked_feature_gather

__all__ = ["layers_to_adjs", "masked_feature_gather"]
