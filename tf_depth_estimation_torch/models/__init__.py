"""Models of the PyTorch port."""
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant

__all__ = ["DepthPoseNet", "DispNet", "DispNetVariant"]
