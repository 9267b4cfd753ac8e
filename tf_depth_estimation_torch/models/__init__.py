"""Models of the PyTorch port."""
from tf_depth_estimation_torch.models.composite import LRNet
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant

__all__ = ["DepthPoseNet", "LRNet", "DispNet", "DispNetVariant", "TurboDepthNet", "TurboVariant"]
