"""Eval forward of DepthPoseNet (depth, pose and explainability) with batch norm folded.

The port of ``tf_depth_estimation_tpu/infer/fast_pose.py:fast_depth_pose_forward``: the
reference ``depth_net`` (``nets_optflow_depth.py:151-276`` truncated,
``nets_optflow_depth_pairtest.py`` full resolution) from a JAX variables tree or a
``DepthPoseNet``, with each eval-mode BN scale folded into its conv kernel and its shift
left as the conv bias, by ``infer/fast.py``'s ``fold_layers``. The JAX module moves the
stem's shift into an extra ones-channel kernel tap because XLA on the TPU compiled the
plain bias-add of a low-channel conv slowly; cuDNN adds a conv bias in its epilogue, so
here the stem's shift is the bias as everywhere else. Inside, tensors are NCHW in the
channels-last memory format; the outputs are NHWC float32, as JAX's.

Equal to ``DepthPoseNet`` in eval mode up to float rounding (``tests/
test_torch_depth_then_cam.py`` holds both against the JAX package). ``PairPredictor``
serves through it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
from torch import nn

from tf_depth_estimation_torch.infer.fast import _cat, fold_layers, float_state
from tf_depth_estimation_torch.models.depth_pose import DEPTH_LEVELS, ENCODER
from tf_depth_estimation_torch.models.layers import conv2d_same, conv_transpose2d_same
from tf_depth_estimation_torch.ops.resize import resize_bilinear, resize_like


def fold_depth_pose(variables_or_module: Union[Dict[str, Any], nn.Module], *,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """``{layer: (weight, bias)}`` of a DepthPoseNet with BN folded, in ``dtype`` on
    ``device``, and ``"dtype"``."""
    folded = fold_layers(float_state(variables_or_module, device), dtype)
    folded["dtype"] = dtype
    return folded


def folded_depth_pose_forward(folded: Dict[str, Any], image_pair: torch.Tensor, *,
                              full_resolution: bool = False, num_source: int = 1,
                              disp_scaling: float = 4.0, min_disp: float = 0.0
                              ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
    """Forward from ``fold_depth_pose``' output. ``image_pair`` [B, H, W, C] (uint8 or
    float, any channel count the stem takes) on the weights' device; returns
    ``(disps, pose [B, num_source, 6], masks)``, float32, NHWC, as
    ``DepthPoseNet(full_resolution, num_source).apply(..., train=False)`` in JAX."""
    H, W = image_pair.shape[1:3]
    # JAX's guard: the decoder needs disp4_up at H/4 to match the twice-halved cnv2b
    if H % 4 or W % 4:
        raise ValueError(f"fast_depth_pose_forward requires H, W divisible by 4, got "
                         f"{H}x{W}")
    dt = folded["dtype"]

    def conv(x, name, stride=1):
        w, b = folded[name]
        return torch.relu(conv2d_same(x, w, b, stride))

    def deconv(x, name):
        w, b = folded[name]
        return torch.relu(conv_transpose2d_same(x, w, b))

    def linear_head(x, name):
        w, b = folded[name]
        return conv2d_same(x, w, b).float()

    def disp_head(x, name):
        return disp_scaling * torch.sigmoid(linear_head(x, name)) + min_disp

    x = image_pair.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=torch.channels_last)
    skips = {}
    for name, _cin, _cout, _k, stride in ENCODER:
        x = conv(x, name, stride)
        skips[name] = x
    cnv6b = skips["cnv6b"]

    pose = linear_head(conv(cnv6b, "pose_cam_cnv7", 2), "pose_pred")
    pose = pose.mean((2, 3)).reshape(-1, num_source, 6)

    e4 = deconv(deconv(skips["cnv5b"], "exp_upcnv5"), "exp_upcnv4")
    e3 = deconv(e4, "exp_upcnv3")
    masks = [linear_head(e3, "mask3"), linear_head(e4, "mask4")]
    if full_resolution:
        e2 = deconv(e3, "exp_upcnv2")
        e1 = deconv(e2, "exp_upcnv1")
        masks = [linear_head(e1, "mask1"), linear_head(e2, "mask2")] + masks

    x = conv(conv(cnv6b, "cnv7", 2), "cnv7b")
    for (lvl, _cin, _cout), skip in zip(DEPTH_LEVELS, ("cnv6b", "cnv5b", "cnv4b", "cnv3b")):
        up = resize_like(deconv(x, f"upcnv{lvl}"), skips[skip])
        x = conv(_cat([up, skips[skip]]), f"icnv{lvl}")
    disp4 = disp_head(x, "disp4")
    disp4_up = resize_bilinear(disp4, (H // 4, W // 4)).to(dt)
    up = resize_like(deconv(x, "upcnv3"), skips["cnv2b"])
    x = conv(_cat([up, skips["cnv2b"], disp4_up]), "icnv3")
    disps = [disp_head(x, "disp3"), disp4]
    if full_resolution:
        disp3_up = resize_bilinear(disps[0], (H // 2, W // 2)).to(dt)
        up = resize_like(deconv(x, "upcnv2"), skips["cnv1b"])
        x = conv(_cat([up, skips["cnv1b"], disp3_up]), "icnv2")
        disp2 = disp_head(x, "disp2")
        disp2_up = resize_bilinear(disp2, (H, W))
        up = deconv(x, "upcnv1")
        if tuple(up.shape[-2:]) != (H, W):
            up = resize_like(up, disp2_up)
        x = conv(_cat([up, disp2_up.to(dt)]), "icnv1")
        disps = [disp_head(x, "disp1"), disp2] + disps
    nhwc = lambda ts: [t.permute(0, 2, 3, 1) for t in ts]
    return nhwc(disps), pose, nhwc(masks)


def fast_depth_pose_forward(variables_or_module: Union[Dict[str, Any], nn.Module],
                            image_pair: torch.Tensor, *, full_resolution: bool = False,
                            num_source: int = 1, disp_scaling: float = 4.0,
                            min_disp: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
    """Eval forward: [B, H, W, C] pair -> (disps, pose [B, num_source, 6], masks), float32
    NHWC. ``image_pair`` is moved to ``device`` and converted to ``dtype`` there."""
    folded = fold_depth_pose(variables_or_module, dtype=dtype, device=device)
    return folded_depth_pose_forward(
        folded, torch.as_tensor(image_pair).to(device), full_resolution=full_resolution,
        num_source=num_source, disp_scaling=disp_scaling, min_disp=min_disp)
