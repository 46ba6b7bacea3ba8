from . import quant
from .sample import (ExactBucketMeta, LayerSample, as_index_rows,
                     as_index_rows_overlapping, butterfly_shuffle,
                     compact_ids, compact_layer, compact_union,
                     compose_slot_map, edge_row_ids, edge_rows,
                     exact_bucket_meta, permute_csr, reshuffle_csr,
                     sample_layer, sample_layer_exact_wide,
                     sample_layer_rotation, sample_layer_window, sample_prob,
                     sample_prob_step, suggest_hub_cap)
from .sample_multihop import sample_multihop, sample_multihop_dedup

__all__ = ["quant", "ExactBucketMeta", "LayerSample", "as_index_rows",
           "as_index_rows_overlapping", "butterfly_shuffle", "compact_ids",
           "compact_layer", "compact_union", "compose_slot_map",
           "edge_row_ids", "edge_rows", "exact_bucket_meta", "permute_csr",
           "reshuffle_csr", "sample_layer", "sample_layer_exact_wide",
           "sample_layer_rotation", "sample_layer_window", "sample_multihop",
           "sample_multihop_dedup", "sample_prob", "sample_prob_step",
           "suggest_hub_cap"]
