"""Models of the PyTorch port."""
from tf_depth_estimation_torch.models.composite import LRNet
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet, PoseExpNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.models.upconv import UpconvNet

__all__ = ["DepthPoseNet", "LRNet", "DispNet", "DispNetVariant", "PoseExpNet",
           "TurboDepthNet", "TurboVariant", "UpconvNet"]
