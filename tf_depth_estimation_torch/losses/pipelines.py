"""Loss pipelines of the PyTorch port (``tf_depth_estimation_tpu/losses/pipelines.py``).

Each mirrors one reference loss graph, takes the predictions and the batch (NHWC, as in
the JAX package) and returns ``(total, components)``. Ported so far: ``depth_only_loss``
and ``depth_only_val_loss`` (BASELINE config 2) and ``optflow_combine_loss`` (config 4);
the others come with their experiments. Every smoothness term goes through
``ops/smoothness.py:smoothness_fused``, the CUDA kernels on the GPU and the plain term on
the CPU.
"""
from __future__ import annotations

from typing import Sequence

import torch

from tf_depth_estimation_torch.geometry.warp import (
    flow_from_coords,
    flow_warp,
    projective_inverse_warp,
)
from tf_depth_estimation_torch.losses.basic import si_log_rmse
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.ops.resize import resize_area
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused


def _area(x: torch.Tensor, hw) -> torch.Tensor:
    """TF1 ``resize_area`` of an NHWC tensor, returned contiguous NHWC."""
    return resize_area(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1).contiguous()


def depth_only_loss(pred_depths: Sequence[torch.Tensor], label: torch.Tensor,
                    w: LossWeights):
    """Supervised depth, BASELINE config 2 (ref ``train_depth_only.py:162-219``): per scale
    a plain (unguarded) L1 to the area-resized label and the smoothness of the raw
    prediction."""
    depth_loss = smooth_loss = 0.0
    for s in range(w.num_scales):
        smooth_loss += w.smooth_weight / 2**s * smoothness_fused(pred_depths[s])
        curr_label = _area(label, w.scale_hw(s))
        depth_loss += (curr_label - pred_depths[s]).abs().mean() * w.depth_weight / 2**s
    total = depth_loss + smooth_loss
    return total, {"total": total, "depth": depth_loss, "smooth": smooth_loss}


def depth_only_val_loss(pred_depths: Sequence[torch.Tensor], label: torch.Tensor,
                        w: LossWeights):
    """Config 2's validation branch (ref ``train_depth_only.py:229-253``): per-scale
    si-log-RMSE and smoothness."""
    depth_loss = smooth_loss = 0.0
    for s in range(w.num_scales):
        smooth_loss += w.smooth_weight / 2**s * smoothness_fused(pred_depths[s])
        curr_label = _area(label, w.scale_hw(s))
        depth_loss += si_log_rmse(curr_label, pred_depths[s]) * w.depth_weight / 2**s
    total = depth_loss + smooth_loss
    return total, {"total": total, "si_log_rmse": depth_loss, "smooth": smooth_loss}


def optflow_combine_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                         pred_depths: Sequence[torch.Tensor],
                         pred_flow_x: Sequence[torch.Tensor],
                         pred_flow_y: Sequence[torch.Tensor], label: torch.Tensor,
                         tgt2src_proj: torch.Tensor, intrinsics: torch.Tensor,
                         w: LossWeights):
    """Joint depth + optical flow (ref ``train_optflow_combine.py:138-240``, BASELINE
    config 4): depth L1, smoothness of depth and both flow components, wmask-weighted
    photometric error of the depth warp and of the flow warp, and flow supervised by the
    GT-depth warp's grid. Three warps per scale: GT depth, predicted depth, flow.
    ``tgt2src_proj`` [B, 4, 4]; ``intrinsics`` [B, S, 3, 3]."""
    depth_loss = smooth_loss = pixel_loss = optflow_loss = 0.0
    for s in range(w.num_scales):
        hw = w.scale_hw(s)
        smooth_loss += w.smooth_weight / 2**s * (
            smoothness_fused(pred_depths[s]) + smoothness_fused(pred_flow_x[s])
            + smoothness_fused(pred_flow_y[s]))
        curr_label = _area(label, hw)
        curr_left = _area(image_left, hw)
        curr_right = _area(image_right, hw)

        depth_loss += (curr_label - pred_depths[s]).abs().mean() * w.depth_weight / 2**s

        gt_warp = projective_inverse_warp(curr_right, 1.0 / curr_label[..., 0],
                                          tgt2src_proj, intrinsics[:, s], fmt="matrix",
                                          sampler=w.sampler)
        pred_warp = projective_inverse_warp(curr_right, 1.0 / pred_depths[s][..., 0],
                                            tgt2src_proj, intrinsics[:, s], fmt="matrix",
                                            sampler=w.sampler)
        wmask = gt_warp.mask  # validity from the GT warp (train_optflow_combine.py:176)
        pixel_loss += ((pred_warp.image - curr_left).abs() * wmask).mean() \
            * w.data_weight / 2**s

        flow_img = flow_warp(curr_right, pred_flow_x[s], pred_flow_y[s], sampler=w.sampler)
        pixel_loss += ((flow_img - curr_left).abs() * wmask).mean() * w.data_weight / 2**s

        gt_fx, gt_fy = flow_from_coords(gt_warp.coords)
        optflow_loss += (pred_flow_x[s] - gt_fx).abs().mean() * w.optflow_weight / 2**s
        optflow_loss += (pred_flow_y[s] - gt_fy).abs().mean() * w.optflow_weight / 2**s

    total = depth_loss + smooth_loss + optflow_loss + pixel_loss
    return total, {"total": total, "depth": depth_loss, "smooth": smooth_loss,
                   "optflow": optflow_loss, "pixel": pixel_loss}
