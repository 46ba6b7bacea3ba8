from . import quant
from .dedup import dedup_take, unique_within_budget
from .quant import HotPlan, QuantizedTensor, plan_hot_capacity
from .sample import (ExactBucketMeta, LayerSample, as_index_rows,
                     as_index_rows_overlapping, butterfly_shuffle,
                     compact_ids, compact_layer, compact_union,
                     compose_slot_map, edge_row_ids, edge_rows,
                     exact_bucket_meta, permute_csr, reshuffle_csr,
                     sample_layer, sample_layer_exact_wide,
                     sample_layer_rotation, sample_layer_window, sample_prob,
                     sample_prob_step, suggest_hub_cap)
from .random_walk import random_walk, random_walk_step
from .sample_multihop import sample_multihop, sample_multihop_dedup
from .weighted import (csr_weights_from_eid, sample_layer_weighted,
                       sample_layer_weighted_window)

__all__ = ["quant", "HotPlan", "QuantizedTensor", "dedup_take",
           "plan_hot_capacity", "unique_within_budget", "ExactBucketMeta", "LayerSample", "as_index_rows",
           "as_index_rows_overlapping", "butterfly_shuffle", "compact_ids",
           "compact_layer", "compact_union", "compose_slot_map",
           "csr_weights_from_eid", "edge_row_ids", "edge_rows",
           "exact_bucket_meta", "permute_csr", "random_walk",
           "random_walk_step", "reshuffle_csr", "sample_layer",
           "sample_layer_exact_wide", "sample_layer_rotation",
           "sample_layer_weighted", "sample_layer_weighted_window",
           "sample_layer_window", "sample_multihop",
           "sample_multihop_dedup", "sample_prob", "sample_prob_step",
           "suggest_hub_cap"]
