"""Batched inference of the PyTorch port."""
from tf_depth_estimation_torch.infer.fast import fast_depth_forward
from tf_depth_estimation_torch.infer.fast_pose import fast_depth_pose_forward
from tf_depth_estimation_torch.infer.fast_turbo import fast_turbo_forward
from tf_depth_estimation_torch.infer.predictor import (
    DepthPredictor,
    FlowAugmentedPredictor,
    PairPredictor,
    TurboPredictor,
)

__all__ = ["DepthPredictor", "FlowAugmentedPredictor", "PairPredictor", "TurboPredictor",
           "fast_depth_forward", "fast_depth_pose_forward", "fast_turbo_forward"]
