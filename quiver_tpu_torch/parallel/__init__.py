from .dist import build_dist_train_step, fold_in, rank_step_seeds
from .mesh import axis_index, axis_size
from .train import (TrainState, build_e2e_train_step, build_split_train_step,
                    build_train_step, cross_entropy_logits,
                    dedup_feature_gather, draw_step_seeds, init_state,
                    layers_to_adjs, masked_feature_gather)

__all__ = ["TrainState", "axis_index", "axis_size", "build_dist_train_step",
           "build_e2e_train_step", "build_split_train_step",
           "build_train_step", "cross_entropy_logits",
           "dedup_feature_gather", "draw_step_seeds", "fold_in",
           "init_state", "layers_to_adjs", "masked_feature_gather",
           "rank_step_seeds"]
