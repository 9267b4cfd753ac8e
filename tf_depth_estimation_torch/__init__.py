"""PyTorch / CUDA port of tf_depth_estimation_tpu for NVIDIA Hopper GPUs.

The JAX package beside it is the reference; this package imports neither JAX nor it. It
serves depth4 DispNet (``infer.DepthPredictor`` and ``infer.fast_depth_forward`` over
``models.DispNet``, with the decoder tail as the CUDA kernel ``csrc/fused_tail.cu``),
trains BASELINE config 4, depth10_flow DispNet on joint depth and optical flow
(``train.experiments.optflow_combine``, with the warps' bilinear sampler as the CUDA
kernels ``csrc/bilinear_sample.cu``, one launch each way for a step's warps), trains BASELINE config 2, depth4 DispNet on supervised depth
(``train.experiments.depth_only``, with the smoothness term as ``csrc/smoothness.cu``),
trains both phases of split_training, DepthPoseNet pairwise and then depth4 DispNet over
[coarse depth | image] (``train.experiments.split_training``, with the
scale-invariant-gradient loss as ``csrc/sig_l2.cu``), trains BASELINE config 3, the
full-resolution DepthPoseNet on self-supervised depth and pose
(``train.experiments.depth_then_cam``, with the fused warp sampler on the same kernels
under JAX's eligibility rule), evaluates the pair family's checkpoints
(``train.experiments.eval_harness``) and serves depth and pose for consecutive frames
(``infer.PairPredictor`` over ``infer.fast_depth_pose_forward``).
"""
from tf_depth_estimation_torch.infer import DepthPredictor, fast_depth_forward
from tf_depth_estimation_torch.models import DispNet, DispNetVariant
from tf_depth_estimation_torch.utils.npz import load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import (
    dispnet_from_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)

__all__ = ["DepthPredictor", "DispNet", "DispNetVariant", "dispnet_from_variables",
           "fast_depth_forward", "load_variables_npz", "save_variables_npz",
           "state_dict_to_variables", "variables_to_state_dict"]
