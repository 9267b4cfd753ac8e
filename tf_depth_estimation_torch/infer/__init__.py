"""Batched inference of the PyTorch port."""
from tf_depth_estimation_torch.infer.fast import fast_depth_forward
from tf_depth_estimation_torch.infer.predictor import DepthPredictor

__all__ = ["DepthPredictor", "fast_depth_forward"]
