"""DispNet encoder-decoder, depth4 variant, as an ``nn.Module`` (NCHW inside).

Mirrors ``tf_depth_estimation_tpu/models/dispnet.py``: 7 stride-2 encoder stages, each
followed by a stride-1 'b' conv (kernels 7, 5, then 3), and a skip-connected deconv decoder
whose sigmoid disparity heads at 1/8..1 resolution feed back through a TF1 bilinear
upsample. This is the plain eval forward, the parity anchor of ``infer/fast.py``. Only the
depth4 variant (``nets_optflow_depth.py``) is ported; the others come with later slices.
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
    disp_scaling: float = 4.0
    min_disp: float = 0.0

    @staticmethod
    def depth4() -> "DispNetVariant":
        """nets_optflow_depth.py: sigmoid*4 heads (BASELINE configs 1/2)."""
        return DispNetVariant("depth4", disp_scaling=4.0, min_disp=0.0)


ENC = ((32, 7), (64, 5), (128, 3), (256, 3), (512, 3), (512, 3), (512, 3))
# decoder level -> (deconv out, iconv in = deconv out + skip (+ 1 fed-back disparity))
DEC = {7: (512, 1024), 6: (512, 1024), 5: (256, 512), 4: (128, 256),
       3: (64, 129), 2: (32, 65), 1: (16, 17)}


class DispNet(nn.Module):
    """depth4 DispNet; ``forward`` returns ``[d1, d2, d3, d4]`` as float32 NCHW."""

    def __init__(self, variant: Optional[DispNetVariant] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.variant = variant or DispNetVariant.depth4()
        g = generator
        self.encoder = nn.ModuleDict()
        cin = 3
        for i, (feat, k) in enumerate(ENC, start=1):
            self.encoder[f"cnv{i}"] = SlimConv(cin, feat, k, 2, generator=g)
            self.encoder[f"cnv{i}b"] = SlimConv(feat, feat, k, 1, generator=g)
            cin = feat
        self.decoder = nn.ModuleDict()
        for lvl in range(7, 0, -1):
            out, cat_in = DEC[lvl]
            self.decoder[f"upcnv{lvl}"] = SlimConv(cin, out, 3, 2, transpose=True,
                                                   generator=g)
            self.decoder[f"icnv{lvl}"] = SlimConv(cat_in, out, 3, 1, generator=g)
            if lvl <= 4:
                self.decoder[f"disp{lvl}"] = TFConv2d(out, 1, 3, bias=True, generator=g)
            cin = out

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image: [B, 3, H, W] in the parameters' dtype."""
        v, dec = self.variant, self.decoder
        H, W = image.shape[-2:]
        x = image
        skips = []
        for i in range(1, 8):
            x = self.encoder[f"cnv{i}b"](self.encoder[f"cnv{i}"](x))
            skips.append(x)

        def head(x, lvl):
            y = torch.sigmoid(dec[f"disp{lvl}"](x))
            return (v.disp_scaling * y + v.min_disp).float()

        def up_cat(x, lvl, extra):  # deconv, patch odd sizes, concat, iconv
            x = resize_like(dec[f"upcnv{lvl}"](x), extra[0])
            return dec[f"icnv{lvl}"](torch.cat([x, *extra], 1))

        up = lambda d, f: resize_bilinear(d, (H // f, W // f)).to(image.dtype)
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
