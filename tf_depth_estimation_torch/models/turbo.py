"""TurboDepthNet, the serving-first depth network of the turbo track, as an ``nn.Module``.

Mirrors ``tf_depth_estimation_tpu/models/turbo.py``: the same sigmoid*4 disparity pyramid
as depth4 DispNet, from a network built for throughput:
  * a patchify stem: the frame is packed to ``H/p x W/p x 3 p^2`` (``ops/phase.py``'s
    ``space_to_depth_n``) and the first conv is a 3x3 at that base grid;
  * stride-2 encoder stages (``enc<i>``, with a stride-1 refinement ``enc<i>b`` when
    ``enc_convs == 2``);
  * an FPN decoder: a 1x1 lateral of the deepest stage, then at each shallower level a
    subpixel upsample (1x1 conv to 4x the channels, depth-to-space), the level's 1x1
    lateral added, and a ``fuse`` conv;
  * subpixel disparity heads: a conv to ``p^2`` channels at the base grid, then
    depth-to-space to full resolution.
Layers and weights keep the JAX names (``stem``, ``enc2b``, ``lat3``, ``up1``, ``fuse1``,
``disp1``), so the committed ``weights/turbo_*.npz`` load through ``weights.py``. Batch
norm follows slim and flax (``SlimBatchNorm``): ``bn_momentum`` 0.99 is flax's decay.
Inputs and outputs are NHWC, as in JAX; NCHW inside.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from tf_depth_estimation_torch.models.layers import SlimConv, TFConv2d
from tf_depth_estimation_torch.ops.phase import depth_to_space_n, space_to_depth_n


@dataclasses.dataclass(frozen=True)
class TurboVariant:
    """Static configuration of the turbo family (JAX ``TurboVariant``).

    ``patch`` is the stem's space-to-depth factor and the head's subpixel factor; inputs
    must be divisible by ``patch * 2**(len(widths)-1)`` in H and W. ``head_kernel`` is
    the disparity heads' conv kernel, ``stem_convs`` the number of stride-1 convs at the
    base grid, ``fuse1_kernel`` the kernel of the base grid's decoder fuse conv and
    ``enc_convs`` the convs of each stride-2 stage.
    """

    name: str
    patch: int = 4
    widths: Tuple[int, ...] = (96, 192, 384, 384)  # encoder channels, 1/4 .. 1/32 res
    fpn_width: int = 128                           # decoder channels at every level
    head_scale: float = 4.0                        # sigmoid*4, matching depth4 heads
    head_offset: float = 0.0
    bn_momentum: float = 0.99
    head_kernel: int = 3
    stem_convs: int = 2
    fuse1_kernel: int = 3
    enc_convs: int = 2

    # class attr, not a dataclass field
    PRESETS = ("base", "small", "wide", "colon", "sprint", "nano", "pico",
               "femto", "atto")

    def __post_init__(self):
        assert self.patch in (2, 4), "subpixel d2 head needs an even patch"
        assert len(self.widths) >= 2
        assert self.stem_convs in (1, 2)
        assert self.enc_convs in (1, 2)

    @staticmethod
    def by_name(name: str) -> "TurboVariant":
        """Preset lookup with a clean error (CLIs pass user input here)."""
        if name not in TurboVariant.PRESETS:
            raise ValueError(
                f"unknown turbo variant {name!r}; choose from {TurboVariant.PRESETS}")
        return getattr(TurboVariant, name)()

    @staticmethod
    def base() -> "TurboVariant":
        """The default operating point."""
        return TurboVariant("base")

    @staticmethod
    def small() -> "TurboVariant":
        """Narrower encoder and decoder."""
        return TurboVariant("small", widths=(64, 128, 256, 256), fpn_width=96)

    @staticmethod
    def wide() -> "TurboVariant":
        """Wider encoder and decoder, for distillation headroom."""
        return TurboVariant("wide", widths=(128, 256, 512, 512), fpn_width=160)

    @staticmethod
    def sprint() -> "TurboVariant":
        """``small`` with 1x1 disparity heads."""
        return TurboVariant("sprint", widths=(64, 128, 256, 256), fpn_width=96,
                            head_kernel=1)

    @staticmethod
    def nano() -> "TurboVariant":
        """``sprint`` with one stem conv."""
        return TurboVariant("nano", widths=(64, 128, 256, 256), fpn_width=96,
                            head_kernel=1, stem_convs=1)

    @staticmethod
    def pico() -> "TurboVariant":
        """``nano`` with a 1x1 base-grid fuse conv."""
        return TurboVariant("pico", widths=(64, 128, 256, 256), fpn_width=96,
                            head_kernel=1, stem_convs=1, fuse1_kernel=1)

    @staticmethod
    def femto() -> "TurboVariant":
        """``pico`` without the encoder refinement convs."""
        return TurboVariant("femto", widths=(64, 128, 256, 256), fpn_width=96,
                            head_kernel=1, stem_convs=1, fuse1_kernel=1,
                            enc_convs=1)

    @staticmethod
    def atto() -> "TurboVariant":
        """``femto`` with a 64-channel FPN decoder."""
        return TurboVariant("atto", widths=(64, 128, 256, 256), fpn_width=64,
                            head_kernel=1, stem_convs=1, fuse1_kernel=1,
                            enc_convs=1)

    @staticmethod
    def colon() -> "TurboVariant":
        """Three stages, so that the colon size 240x720 (divisible by 16, not 32) fits."""
        return TurboVariant("colon", widths=(96, 192, 384))

    def min_hw_multiple(self) -> int:
        return self.patch * 2 ** (len(self.widths) - 1)

    def check_size(self, height: int, width: int) -> None:
        """Raise ``ValueError`` unless H and W divide by ``min_hw_multiple()``."""
        m = self.min_hw_multiple()
        if height % m or width % m:
            raise ValueError(f"turbo-{self.name} needs H, W divisible by {m}, got "
                             f"{height}x{width}")


def subpixel_up(x: torch.Tensor, n: int) -> torch.Tensor:
    """NCHW depth-to-space with ``ops/phase.py``'s (p, q, c) channel order."""
    return depth_to_space_n(x.permute(0, 2, 3, 1), n).permute(0, 3, 1, 2)


# conv(x, layer name, stride, relu) -> y, NCHW
ConvFn = Callable[[torch.Tensor, str, int, bool], torch.Tensor]


def decoder_levels(x: torch.Tensor, v: TurboVariant,
                   conv: ConvFn) -> Dict[int, torch.Tensor]:
    """The turbo graph from the packed stem input ``x`` (NCHW, 3 p^2 channels) to the
    decoder levels (1 = the base grid), with ``conv`` running each named layer: the
    module's layers or the folded kernels of ``infer/fast_turbo.py``."""
    feats = []
    x = conv(x, "stem", 1, True)
    if v.stem_convs == 2:
        x = conv(x, "stemb", 1, True)
    feats.append(x)
    for i in range(2, len(v.widths) + 1):
        x = conv(x, f"enc{i}", 2, True)
        if v.enc_convs == 2:
            x = conv(x, f"enc{i}b", 1, True)
        feats.append(x)
    y = conv(feats[-1], f"lat{len(feats)}", 1, False)
    levels = {}
    for lvl in range(len(feats) - 1, 0, -1):
        y = subpixel_up(conv(y, f"up{lvl}", 1, False), 2)
        y = y + conv(feats[lvl - 1], f"lat{lvl}", 1, False)
        y = conv(y, f"fuse{lvl}", 1, True)
        levels[lvl] = y
    return levels


def stem_input(image: torch.Tensor, v: TurboVariant, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, W, 3] NHWC image -> the packed NCHW stem input in ``dtype``."""
    v.check_size(*image.shape[1:3])
    return space_to_depth_n(image.to(dtype), v.patch).permute(0, 3, 1, 2)


def to_disp(logits: torch.Tensor, v: TurboVariant) -> torch.Tensor:
    return (v.head_scale * torch.sigmoid(logits) + v.head_offset).float()


class TurboDepthNet(nn.Module):
    """``forward(image)`` returns ``[d1, d2, d3, d4]``, sigmoid*4 disparities at full,
    1/2, 1/4 and 1/8 resolution, float32 NHWC [B, h, w, 1], or ``[d1]`` with
    ``full_only=True`` (the serving graph). ``image`` is NHWC [B, H, W, 3], any float
    dtype, cast to ``dtype``; the parameters and BN statistics stay float32. Train mode
    uses and updates the batch statistics, eval mode the running ones."""

    def __init__(self, variant: TurboVariant, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        v = self.variant = variant
        self.dtype = dtype
        g, m, w, f = generator, v.bn_momentum, v.widths, v.fpn_width
        conv = lambda cin, cout, k, stride=1, relu=True: SlimConv(
            cin, cout, k, stride, generator=g, bn_momentum=m, relu=relu)
        self.stem = conv(3 * v.patch ** 2, w[0], 3)
        if v.stem_convs == 2:
            self.stemb = conv(w[0], w[0], 3)
        for i in range(2, len(w) + 1):
            setattr(self, f"enc{i}", conv(w[i - 2], w[i - 1], 3, 2))
            if v.enc_convs == 2:
                setattr(self, f"enc{i}b", conv(w[i - 1], w[i - 1], 3))
        setattr(self, f"lat{len(w)}", conv(w[-1], f, 1, relu=False))
        for lvl in range(len(w) - 1, 0, -1):
            setattr(self, f"up{lvl}", conv(f, 4 * f, 1, relu=False))
            setattr(self, f"lat{lvl}", conv(w[lvl - 1], f, 1, relu=False))
            setattr(self, f"fuse{lvl}", conv(f, f, v.fuse1_kernel if lvl == 1 else 3))
        p, hk = v.patch, v.head_kernel
        for name, ch in (("disp1", p * p), ("disp2", (p // 2) ** 2), ("disp3", 1),
                         ("disp4", 1)):
            setattr(self, name, TFConv2d(f, ch, hk, bias=True, generator=g))
        # d3 and d4 read the decoder levels at 1/4 and 1/8 of the input
        self.level3 = {4: 1, 2: 2}[p]

    def forward(self, image: torch.Tensor, full_only: bool = False) -> List[torch.Tensor]:
        v, p = self.variant, self.variant.patch
        levels = decoder_levels(stem_input(image, v, self.dtype), v,
                                lambda x, name, _stride, _relu: getattr(self, name)(x))

        def head(lvl: int, name: str, n: int) -> torch.Tensor:
            logits = getattr(self, name)(levels[lvl]).permute(0, 2, 3, 1)
            return to_disp(depth_to_space_n(logits, n) if n > 1 else logits, v)

        d1 = head(1, "disp1", p)
        if full_only:
            return [d1]
        assert self.level3 + 1 in levels, (
            f"turbo-{v.name}: need >= {self.level3 + 2} encoder stages for the 1/8 head")
        return [d1, head(1, "disp2", p // 2), head(self.level3, "disp3", 1),
                head(self.level3 + 1, "disp4", 1)]

    def forward_nhwc(self, image: torch.Tensor) -> List[torch.Tensor]:
        """The pyramid; ``forward`` already takes and returns NHWC, the layout the losses
        use (``DispNet.forward_nhwc`` answers the same call)."""
        return self(image)
