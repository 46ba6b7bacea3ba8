from .dist import build_dist_train_step, fold_in, rank_step_seeds
from .gspmd import (ColumnParallelLinear, build_gspmd_train_step,
                    full_parameters, keyed_walk, shard_state,
                    state_sharding)
from .mesh import (Mesh, axis_index, axis_size, make_mesh, replicated,
                   row_sharded)
from .train import (TrainState, build_e2e_train_step, build_split_train_step,
                    build_train_step, cross_entropy_logits,
                    dedup_feature_gather, draw_step_seeds, init_state,
                    layers_to_adjs, masked_feature_gather, store_gather)

__all__ = ["ColumnParallelLinear", "Mesh", "TrainState", "axis_index",
           "axis_size",
           "build_dist_train_step", "build_e2e_train_step",
           "build_gspmd_train_step", "build_split_train_step",
           "build_train_step", "cross_entropy_logits",
           "dedup_feature_gather", "draw_step_seeds", "fold_in",
           "full_parameters", "init_state", "keyed_walk", "layers_to_adjs",
           "make_mesh",
           "masked_feature_gather", "rank_step_seeds", "replicated",
           "row_sharded", "shard_state", "state_sharding", "store_gather"]
