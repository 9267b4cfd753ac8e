"""Joint depth, camera-pose and explainability networks as ``nn.Module``s (NCHW inside).

``DepthPoseNet`` mirrors ``tf_depth_estimation_tpu/models/depth_pose.py:DepthPoseNet``, the reference's
``depth_net`` of the pairwise experiments: the truncated-decoder variant
(``nets_optflow_depth.py:151-276``, ``full_resolution=False``) and the full-resolution one
(``nets_optflow_depth_pairtest.py:151-276``). A shared encoder cnv1..cnv6b feeds a pose
head (a stride-2 conv and a 1x1 linear conv, the UNSCALED mean over its pixels), an
explainability decoder from cnv5b, and a depth decoder through cnv7 whose heads are
``disp_scaling * sigmoid + min_disp``. The layers are the module's direct children, named
as the flax module's, so the state dict's keys are the JAX tree's paths
(``weights.py``). ``in_channels`` is cnv1's input: 6 for a stacked pair, 11 for the
flow-augmented input of ``infer/predictor.py:FlowAugmentedPredictor``.

``PoseExpNet`` mirrors ``tf_depth_estimation_tpu/models/depth_pose.py:PoseExpNet``, the
SfMLearner-style ``pose_exp_net`` (``nets.py:18-74``): five stride-2 convs, a pose head of
two more and a 1x1 linear conv whose mean is scaled by 0.01, and an explainability decoder
of five deconvs from cnv5 with a linear mask head at each of its last four.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from tf_depth_estimation_torch.models.layers import SlimConv, TFConv2d
from tf_depth_estimation_torch.ops.resize import resize_bilinear, resize_like

# (name, in, out, kernel, stride) of the encoder
ENCODER = (("cnv1", 6, 32, 7, 2), ("cnv1b", 32, 32, 7, 1), ("cnv2", 32, 64, 5, 2),
           ("cnv2b", 64, 64, 5, 1), ("cnv3", 64, 128, 3, 2), ("cnv3b", 128, 128, 3, 1),
           ("cnv4", 128, 256, 3, 2), ("cnv4b", 256, 256, 3, 1), ("cnv5", 256, 512, 3, 2),
           ("cnv5b", 512, 512, 3, 1), ("cnv6", 512, 512, 3, 2), ("cnv6b", 512, 512, 3, 1))
# depth decoder levels 7..4: (deconv in, deconv out); the iconv takes out + skip channels
DEPTH_LEVELS = ((7, 512, 512), (6, 512, 512), (5, 512, 256), (4, 256, 128))
# PoseExpNet's explainability decoder: (level, deconv out, kernel of the deconv and of the
# level's mask head); levels 4..1 carry a mask head
EXP_LEVELS = ((5, 256, 3), (4, 128, 3), (3, 64, 3), (2, 32, 5), (1, 16, 7))


class DepthPoseNet(nn.Module):
    """``forward(image_pair [B, in_channels, H, W])`` returns ``(disps, pose, masks)``, float32:

    * truncated: ``disps = [disp3, disp4]`` (1/4 and 1/8 resolution, [B, 1, h, w]),
      ``masks = [mask3, mask4]`` ([B, 2 * num_source, h, w] logits);
    * full resolution: ``disps = [disp1 .. disp4]``, ``masks = [mask1 .. mask4]``;
    * ``pose`` [B, num_source, 6].

    ``dtype`` is the compute dtype as in ``DispNet``: the input and every layer's weights
    are cast to it, parameters and batch-norm statistics stay float32, the heads are cast
    to float32 before their sigmoid or mean, as the flax module does.
    """

    def __init__(self, full_resolution: bool = False, num_source: int = 1,
                 disp_scaling: float = 4.0, min_disp: float = 0.0,
                 bn_momentum: float = 0.99, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, in_channels: int = 6):
        super().__init__()
        self.full_resolution = full_resolution
        self.num_source = num_source
        self.disp_scaling, self.min_disp = disp_scaling, min_disp
        self.dtype = dtype
        g, m = generator, bn_momentum

        def conv(name, cin, cout, k, s=1):
            self.add_module(name, SlimConv(cin, cout, k, s, generator=g, bn_momentum=m))

        def deconv(name, cin, cout, k):
            self.add_module(name, SlimConv(cin, cout, k, 2, transpose=True, generator=g,
                                           bn_momentum=m))

        def head(name, cin, cout, k):
            self.add_module(name, TFConv2d(cin, cout, k, bias=True, generator=g))

        for name, cin, cout, k, s in ENCODER:
            conv(name, in_channels if name == "cnv1" else cin, cout, k, s)
        conv("pose_cam_cnv7", 512, 256, 3, 2)
        head("pose_pred", 256, 6 * num_source, 1)
        deconv("exp_upcnv5", 512, 256, 3)
        deconv("exp_upcnv4", 256, 128, 3)
        head("mask4", 128, 2 * num_source, 3)
        deconv("exp_upcnv3", 128, 64, 3)
        head("mask3", 64, 2 * num_source, 3)
        if full_resolution:
            deconv("exp_upcnv2", 64, 32, 5)
            head("mask2", 32, 2 * num_source, 5)
            deconv("exp_upcnv1", 32, 16, 7)
            head("mask1", 16, 2 * num_source, 7)
        conv("cnv7", 512, 512, 3, 2)
        conv("cnv7b", 512, 512, 3)
        for lvl, cin, cout in DEPTH_LEVELS:
            deconv(f"upcnv{lvl}", cin, cout, 3)
            conv(f"icnv{lvl}", 2 * cout, cout, 3)
        head("disp4", 128, 1, 3)
        deconv("upcnv3", 128, 64, 3)
        conv("icnv3", 64 + 64 + 1, 64, 3)
        head("disp3", 64, 1, 3)
        if full_resolution:
            deconv("upcnv2", 64, 32, 3)
            conv("icnv2", 32 + 32 + 1, 32, 3)
            head("disp2", 32, 1, 3)
            deconv("upcnv1", 32, 16, 3)
            conv("icnv1", 16 + 1, 16, 3)
            head("disp1", 16, 1, 3)

    def _linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.get_submodule(name)(x).float()

    def _disp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.disp_scaling * torch.sigmoid(self._linear(name, x)) + self.min_disp

    def forward(self, image_pair: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
        H, W = image_pair.shape[-2:]
        layer = self.get_submodule
        x = image_pair.to(self.dtype)
        skips = {}
        for name, *_ in ENCODER:
            x = layer(name)(x)
            skips[name] = x
        cnv6b = skips["cnv6b"]

        cam = layer("pose_cam_cnv7")(cnv6b)
        pose = self._linear("pose_pred", cam).mean((2, 3)).reshape(-1, self.num_source, 6)

        e4 = layer("exp_upcnv4")(layer("exp_upcnv5")(skips["cnv5b"]))
        mask4 = self._linear("mask4", e4)
        e3 = layer("exp_upcnv3")(e4)
        masks = [self._linear("mask3", e3), mask4]
        if self.full_resolution:
            e2 = layer("exp_upcnv2")(e3)
            e1 = layer("exp_upcnv1")(e2)
            masks = [self._linear("mask1", e1), self._linear("mask2", e2)] + masks

        x = layer("cnv7b")(layer("cnv7")(cnv6b))
        for lvl, skip in ((7, "cnv6b"), (6, "cnv5b"), (5, "cnv4b"), (4, "cnv3b")):
            up = resize_like(layer(f"upcnv{lvl}")(x), skips[skip])
            x = layer(f"icnv{lvl}")(torch.cat([up, skips[skip]], 1))
        disp4 = self._disp("disp4", x)
        disp4_up = resize_bilinear(disp4, (H // 4, W // 4)).to(self.dtype)
        up = resize_like(layer("upcnv3")(x), skips["cnv2b"])
        x = layer("icnv3")(torch.cat([up, skips["cnv2b"], disp4_up], 1))
        disp3 = self._disp("disp3", x)
        if not self.full_resolution:
            return [disp3, disp4], pose, masks

        disp3_up = resize_bilinear(disp3, (H // 2, W // 2)).to(self.dtype)
        up = resize_like(layer("upcnv2")(x), skips["cnv1b"])
        x = layer("icnv2")(torch.cat([up, skips["cnv1b"], disp3_up], 1))
        disp2 = self._disp("disp2", x)
        disp2_up = resize_bilinear(disp2, (H, W))
        up = layer("upcnv1")(x)
        if tuple(up.shape[-2:]) != (H, W):
            up = resize_like(up, disp2_up)
        x = layer("icnv1")(torch.cat([up, disp2_up.to(self.dtype)], 1))
        return [self._disp("disp1", x), disp2, disp3, disp4], pose, masks

    def forward_nhwc(self, image_pair: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
        """``forward`` in the layout the losses use: the pair [B, H, W, 6], the disparities
        and mask logits [B, h, w, c]; the pose as there."""
        disps, pose, masks = self(image_pair.permute(0, 3, 1, 2))
        return ([d.permute(0, 2, 3, 1) for d in disps], pose,
                [m.permute(0, 2, 3, 1) for m in masks])


class PoseExpNet(nn.Module):
    """``forward(inputs [B, in_channels, H, W])``, the target and ``num_source`` sources on
    channels (``in_channels`` 3 * (1 + num_source) by default), returns ``(pose, masks)``:
    ``pose`` [B, num_source, 6], 0.01 times the mean of the 1x1 head (``nets.py:47``), and
    ``masks = [mask1 .. mask4]`` ([B, 2 * num_source, h, w] logits, full resolution
    first), or four ``None`` without ``do_exp``, float32. ``dtype`` as in
    ``DepthPoseNet``; batch-norm decay 0.999 (slim's default)."""

    def __init__(self, num_source: int = 1, do_exp: bool = True, bn_momentum: float = 0.999,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, in_channels: Optional[int] = None):
        super().__init__()
        self.num_source, self.do_exp, self.dtype = num_source, do_exp, dtype
        g, m = generator, bn_momentum
        cin = in_channels or 3 * (1 + num_source)
        for name, cout, k in (("cnv1", 16, 7), ("cnv2", 32, 5), ("cnv3", 64, 3),
                              ("cnv4", 128, 3), ("cnv5", 256, 3), ("pose_cnv6", 256, 3),
                              ("pose_cnv7", 256, 3)):
            self.add_module(name, SlimConv(cin, cout, k, 2, generator=g, bn_momentum=m))
            cin = cout
        self.pose_pred = TFConv2d(256, 6 * num_source, 1, bias=True, generator=g)
        if do_exp:
            cin = 256
            for lvl, cout, k in EXP_LEVELS:
                self.add_module(f"exp_upcnv{lvl}", SlimConv(cin, cout, k, 2, transpose=True,
                                                            generator=g, bn_momentum=m))
                if lvl <= 4:
                    self.add_module(f"mask{lvl}", TFConv2d(cout, 2 * num_source, k,
                                                           bias=True, generator=g))
                cin = cout

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
        layer = self.get_submodule
        cnv5 = inputs.to(self.dtype)
        for name in ("cnv1", "cnv2", "cnv3", "cnv4", "cnv5"):
            cnv5 = layer(name)(cnv5)
        cam = layer("pose_cnv7")(layer("pose_cnv6")(cnv5))
        pose = 0.01 * self.pose_pred(cam).float().mean((2, 3)).reshape(-1, self.num_source, 6)
        if not self.do_exp:
            return pose, [None, None, None, None]
        x, masks = cnv5, []
        for lvl, _, _ in EXP_LEVELS:
            x = layer(f"exp_upcnv{lvl}")(x)
            if lvl <= 4:
                masks.insert(0, layer(f"mask{lvl}")(x).float())
        return pose, masks

    def forward_nhwc(self, inputs: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
        """``forward`` on [B, H, W, C] inputs, the masks [B, h, w, 2 * num_source]."""
        pose, masks = self(inputs.permute(0, 3, 1, 2))
        return pose, [m if m is None else m.permute(0, 2, 3, 1) for m in masks]
