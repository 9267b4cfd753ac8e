"""Batched inference of the PyTorch port."""
from tf_depth_estimation_torch.infer.fast import fast_depth_forward
from tf_depth_estimation_torch.infer.fast_pose import fast_depth_pose_forward
from tf_depth_estimation_torch.infer.predictor import DepthPredictor, PairPredictor

__all__ = ["DepthPredictor", "PairPredictor", "fast_depth_forward", "fast_depth_pose_forward"]
