"""DispNet encoder-decoder as an ``nn.Module`` (NCHW inside): the depth4, depth10_flow,
sfm and depth4_nobn variants.

Mirrors ``tf_depth_estimation_tpu/models/dispnet.py``: 7 stride-2 encoder stages, each
followed by a stride-1 'b' conv (kernels 7, 5, then 3), and a skip-connected deconv decoder
whose disparity heads at 1/8..1 resolution feed back through a TF1 bilinear upsample. The
variant sets the heads (``head_channels``, sigmoid or linear, scale and offset) and whether
the layers carry a batch norm: depth4 (``nets_optflow_depth.py``) has 1-channel sigmoid * 4
heads; sfm (``nets.py``) 3-channel linear heads, which feed back 3 channels into icnv3..1;
depth4_nobn (``nets_optflow_depth_pairtest.py``) depth4's heads and no batch norm (each
layer a conv with a bias and a ReLU). The depth10_flow variant (``nets_depth.py``) adds a
second decoder, ``flow_decoder``, whose layers carry the suffix ``_opt`` and whose heads are
2-channel and linear. It runs in train mode (batch statistics) and eval mode (running
statistics).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from tf_depth_estimation_torch.models.layers import SlimConv, TFConv2d
from tf_depth_estimation_torch.ops.resize import resize_bilinear, resize_like


@dataclasses.dataclass(frozen=True)
class DispNetVariant:
    """Static configuration of a reference disp_net flavour."""

    name: str
    head_channels: int = 1
    head_activation: Optional[str] = "sigmoid"   # "sigmoid" or None (linear)
    disp_scaling: float = 4.0
    min_disp: float = 0.0
    use_bn: bool = True
    bn_momentum: float = 0.99
    flow_decoder: bool = False

    @staticmethod
    def sfm() -> "DispNetVariant":
        """nets.py: 3-channel linear heads, slim's default bn decay 0.999, no scaling."""
        return DispNetVariant("sfm", head_channels=3, head_activation=None,
                              disp_scaling=1.0, min_disp=0.0, bn_momentum=0.999)

    @staticmethod
    def depth4() -> "DispNetVariant":
        """nets_optflow_depth.py: sigmoid*4 heads, bn decay 0.99 (BASELINE configs 1/2)."""
        return DispNetVariant("depth4", disp_scaling=4.0, min_disp=0.0, bn_momentum=0.99)

    @staticmethod
    def depth10_flow() -> "DispNetVariant":
        """nets_depth.py: sigmoid*10 + 0.001 depth heads, bn decay 0.999, and a parallel
        flow decoder (BASELINE config 4)."""
        return DispNetVariant("depth10_flow", disp_scaling=10.0, min_disp=0.001,
                              bn_momentum=0.999, flow_decoder=True)

    @staticmethod
    def depth4_nobn() -> "DispNetVariant":
        """nets_optflow_depth_pairtest.py: sigmoid*4 heads, batch norm disabled."""
        return DispNetVariant("depth4_nobn", disp_scaling=4.0, use_bn=False)


ENC = ((32, 7), (64, 5), (128, 3), (256, 3), (512, 3), (512, 3), (512, 3))
# decoder level -> (deconv out, skip channels); levels 3..1 also take the fed-back head
DEC = {7: (512, 512), 6: (512, 512), 5: (256, 256), 4: (128, 128), 3: (64, 64),
       2: (32, 32), 1: (16, 0)}


def _decoder(v: DispNetVariant, head_channels: int, suffix: str,
             generator: Optional[torch.Generator]) -> nn.ModuleDict:
    dec = nn.ModuleDict()
    cin = ENC[-1][0]
    kw = dict(generator=generator, bn_momentum=v.bn_momentum, use_bn=v.use_bn)
    for lvl in range(7, 0, -1):
        out, skip = DEC[lvl]
        cat_in = out + skip + (head_channels if lvl <= 3 else 0)
        dec[f"upcnv{lvl}{suffix}"] = SlimConv(cin, out, 3, 2, transpose=True, **kw)
        dec[f"icnv{lvl}{suffix}"] = SlimConv(cat_in, out, 3, 1, **kw)
        if lvl <= 4:
            dec[f"disp{lvl}{suffix}"] = TFConv2d(out, head_channels, 3, bias=True,
                                                 generator=generator)
        cin = out
    return dec


class DispNet(nn.Module):
    """``forward`` returns ``[d1, d2, d3, d4]`` (``head_channels`` each; and for
    depth10_flow ``+ [f1, f2, f3, f4]``, 2-channel flows), float32 NCHW, full resolution
    first.

    ``in_channels`` is the input's: 3 for an image, 4 for split_training's phase 2
    ([coarse depth | image]), 6 for a stacked pair. ``dtype`` is the compute dtype: the
    image and every layer's weights are cast to it, the parameters stay float32, the
    batch-norm statistics are float32 and the heads are cast to float32, as the JAX
    module does with ``DispNet(dtype=bfloat16)``.
    """

    def __init__(self, variant: Optional[DispNetVariant] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.variant = variant or DispNetVariant.depth4()
        self.dtype = dtype
        v, g = self.variant, generator
        kw = dict(generator=g, bn_momentum=v.bn_momentum, use_bn=v.use_bn)
        self.encoder = nn.ModuleDict()
        cin = in_channels
        for i, (feat, k) in enumerate(ENC, start=1):
            self.encoder[f"cnv{i}"] = SlimConv(cin, feat, k, 2, **kw)
            self.encoder[f"cnv{i}b"] = SlimConv(feat, feat, k, 1, **kw)
            cin = feat
        self.decoder = _decoder(v, v.head_channels, "", g)
        if v.flow_decoder:
            self.flow_decoder = _decoder(v, 2, "_opt", g)

    def _decode(self, dec: nn.ModuleDict, sfx: str, skips, hw, scale: float,
                offset: float, sigmoid: bool) -> List[torch.Tensor]:
        H, W = hw
        dtype = skips[0].dtype

        def head(x, lvl):
            y = dec[f"disp{lvl}{sfx}"](x)
            if sigmoid:
                y = torch.sigmoid(y)
            return (scale * y + offset).float()

        def up_cat(x, lvl, extra):  # deconv, patch odd sizes, concat, iconv
            x = resize_like(dec[f"upcnv{lvl}{sfx}"](x), extra[0])
            return dec[f"icnv{lvl}{sfx}"](torch.cat([x, *extra], 1))

        up = lambda d, f: resize_bilinear(d, (H // f, W // f)).to(dtype)
        x = skips[6]
        for lvl in (7, 6, 5, 4):
            x = up_cat(x, lvl, [skips[lvl - 2]])
        d4 = head(x, 4)
        x = up_cat(x, 3, [skips[1], up(d4, 4)])
        d3 = head(x, 3)
        x = up_cat(x, 2, [skips[0], up(d3, 2)])
        d2 = head(x, 2)
        x = up_cat(x, 1, [up(d2, 1)])
        return [head(x, 1), d2, d3, d4]

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image: [B, in_channels, H, W], any float dtype; it is cast to the compute
        dtype."""
        v = self.variant
        hw = image.shape[-2:]
        x = image.to(self.dtype)
        skips = []
        for i in range(1, 8):
            x = self.encoder[f"cnv{i}b"](self.encoder[f"cnv{i}"](x))
            skips.append(x)
        disps = self._decode(self.decoder, "", skips, hw, v.disp_scaling, v.min_disp,
                             sigmoid=v.head_activation == "sigmoid")
        if not v.flow_decoder:
            return disps
        return disps + self._decode(self.flow_decoder, "_opt", skips, hw, 1.0, 0.0,
                                    sigmoid=False)

    def forward_nhwc(self, image: torch.Tensor) -> List[torch.Tensor]:
        """``forward`` in the layout the losses use: image [B, H, W, in_channels], the
        outputs [B, h, w, c]."""
        return [o.permute(0, 2, 3, 1) for o in self(image.permute(0, 3, 1, 2))]
