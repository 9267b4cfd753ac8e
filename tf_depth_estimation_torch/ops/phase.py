"""Pixel packing between full resolution and 2x2 phase cells (NHWC).

Packed channels are in ``(p, q, c)`` order, row phase first:
``packed[..., (p*2+q)*C + c] == full[2u+p, 2v+q, c]``, as in
``tf_depth_estimation_tpu/ops/phase.py``. The rest of that module re-lays convolutions out
for the TPU's matrix unit and computes what plain convolutions compute, so it has no
counterpart here.
"""
from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B,2H,2W,C] -> [B,H,W,4C] with (p,q,c) channel order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,4C] with (p,q,c) channel order -> [B,2H,2W,C]."""
    B, H, W, C4 = x.shape
    C = C4 // 4
    x = x.reshape(B, H, W, 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C)
