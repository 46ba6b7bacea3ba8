from .train import (TrainState, build_split_train_step, build_train_step,
                    cross_entropy_logits, dedup_feature_gather,
                    draw_step_seeds, init_state, layers_to_adjs,
                    masked_feature_gather)

__all__ = ["TrainState", "build_split_train_step", "build_train_step",
           "cross_entropy_logits", "dedup_feature_gather",
           "draw_step_seeds", "init_state", "layers_to_adjs",
           "masked_feature_gather"]
