"""FPN-style upconvolution decoder over five backbone endpoints, as an ``nn.Module``
(NCHW inside).

Mirrors ``tf_depth_estimation_tpu/models/upconv.py:UpconvNet``, the reference's
``upconvolution_net`` (``nets_optflow_depth.py:279-333``): 1x1 lateral convs with batch
norm and ReLU, each nearest-resized to the next endpoint and added to it, and four linear
disparity heads. The endpoints come deepest first (the reference fed ResNet-v2-50's); the
laterals give 512, 256, 64 and 64 channels, so r1..r4 must have those, and r0's count is
``in_channels`` (flax infers it from the input). Before the disp3 head the sum grows by
one pixel each way through a TF1 bilinear resize, as the reference does
(``nets_optflow_depth.py:313``). The layers are named as the flax module's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from tf_depth_estimation_torch.models.layers import SlimConv, TFConv2d
from tf_depth_estimation_torch.ops.resize import resize_bilinear, resize_like

# lateral -> (in, out) channels
LATERALS = (("upcnv5", None, 512), ("upcnv4", 512, 256), ("upcnv3", 256, 64),
            ("upcnv2", 64, 64), ("upcnv1", 64, 32))
HEADS = (("disp4", 256), ("disp3", 64), ("disp2", 64), ("disp1", 32))


class UpconvNet(nn.Module):
    """``forward(endpoints)``: five NCHW maps deepest first -> ``[disp1, disp2, disp3,
    disp4]`` [B, 1, h, w] float32, the finest first. ``dtype`` as in ``DispNet``."""

    def __init__(self, in_channels: int = 2048, bn_momentum: float = 0.999,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in LATERALS:
            self.add_module(name, SlimConv(cin or in_channels, cout, 1, generator=generator,
                                           bn_momentum=bn_momentum))
        for name, cin in HEADS:
            self.add_module(name, TFConv2d(cin, 1, 3, bias=True, generator=generator))

    def forward(self, endpoints: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(endpoints) != 5:
            raise ValueError("UpconvNet expects 5 backbone endpoints, deepest first")
        r0, r1, r2, r3, r4 = (e.to(self.dtype) for e in endpoints)
        head = lambda name, x: self.get_submodule(name)(x).float()
        i5 = resize_like(self.upcnv5(r0), r1) + r1
        i4 = resize_like(self.upcnv4(i5), r2) + r2
        disp4 = head("disp4", i4)
        i3 = resize_like(self.upcnv3(i4), r3) + r3
        i3 = resize_bilinear(i3, (i3.shape[-2] + 1, i3.shape[-1] + 1)).to(self.dtype)
        disp3 = head("disp3", i3)
        i2 = resize_like(self.upcnv2(i3), r4) + r4
        disp2 = head("disp2", i2)
        u1 = resize_bilinear(self.upcnv1(i2), (disp2.shape[-2] * 2, disp2.shape[-1] * 2))
        disp1 = head("disp1", u1.to(self.dtype))
        return [disp1, disp2, disp3, disp4]

    def forward_nhwc(self, endpoints: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``forward`` on [B, h, w, C] endpoints, the heads [B, h, w, 1]."""
        outs = self([e.permute(0, 3, 1, 2) for e in endpoints])
        return [o.permute(0, 2, 3, 1) for o in outs]
