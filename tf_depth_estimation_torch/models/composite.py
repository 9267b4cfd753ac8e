"""The composite model of the symmetric L/R experiments as an ``nn.Module``.

Mirrors ``tf_depth_estimation_tpu/models/composite.py:LRNet`` (ref
``train_depth_then_cam_lr.py:120-154``): a depth4 ``DispNet`` applied to each view with
shared weights (``single``) and a full-resolution ``DepthPoseNet`` applied to (L | R) and
to (R | L) (``pair``). The submodules carry the flax module's names, so the state dict's
keys are the JAX tree's paths (``single.encoder.cnv1...``, ``pair.cnv1...``;
``weights.py:lrnet_from_variables``). In train mode each shared submodule moves its
batch-norm running statistics twice a forward, the second pass from the first's result, as
flax moves them within one ``apply``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant


class LRNet(nn.Module):
    """``forward(image_left, image_right)`` ([B, H, W, 3] each) returns JAX's dict:
    ``single_left`` / ``single_right`` (with ``with_single``; depth4's four disparities
    [B, h, w, 1]), ``pair_left`` / ``pair_right`` (the pair net's four disparities of the
    first view), ``pose_right`` / ``pose_left`` ([B, 1, 6]) and ``exp_left`` /
    ``exp_right`` (four mask logits [B, h, w, 2]), all float32 NHWC. ``dtype`` is the
    compute dtype of both submodules."""

    def __init__(self, with_single: bool = True, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.with_single = with_single
        if with_single:
            self.single = DispNet(DispNetVariant.depth4(), generator=generator, dtype=dtype)
        self.pair = DepthPoseNet(full_resolution=True, generator=generator, dtype=dtype)

    def forward(self, image_left: torch.Tensor,
                image_right: torch.Tensor) -> Dict[str, object]:
        out = {}
        if self.with_single:
            out["single_left"] = self.single.forward_nhwc(image_left)
            out["single_right"] = self.single.forward_nhwc(image_right)
        d_l, pose_r, exp_l = self.pair.forward_nhwc(torch.cat([image_left, image_right], -1))
        d_r, pose_l, exp_r = self.pair.forward_nhwc(torch.cat([image_right, image_left], -1))
        out.update(pair_left=d_l, pair_right=d_r, pose_right=pose_r, pose_left=pose_l,
                   exp_left=exp_l, exp_right=exp_r)
        return out
