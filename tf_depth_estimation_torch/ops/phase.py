"""Pixel packing between full resolution and 2x2 phase cells (NHWC).

Packed channels are in ``(p, q, c)`` order, row phase first:
``packed[..., (p*2+q)*C + c] == full[2u+p, 2v+q, c]``, as in
``tf_depth_estimation_tpu/ops/phase.py``; the ``_n`` pair packs n x n cells in the same
order, ``packed[..., (p*n+q)*C + c] == full[n*u+p, n*v+q, c]``, for TurboDepthNet's
patchify stem and subpixel heads and upsamples. The rest of that module re-lays
convolutions out for the TPU's matrix unit and computes what plain convolutions compute,
so it has no counterpart here.
"""
from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B,2H,2W,C] -> [B,H,W,4C] with (p,q,c) channel order."""
    return space_to_depth_n(x, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,4C] with (p,q,c) channel order -> [B,2H,2W,C]."""
    return depth_to_space_n(x, 2)


def space_to_depth_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B,nH,nW,C] -> [B,H,W,n*n*C] with (p,q,c) channel order."""
    B, H, W, C = x.shape
    if H % n or W % n:
        raise ValueError(f"space_to_depth_n: {tuple(x.shape)} is not divisible by {n}")
    x = x.reshape(B, H // n, n, W // n, n, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // n, W // n, n * n * C)


def depth_to_space_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B,H,W,n*n*C] with (p,q,c) channel order -> [B,nH,nW,C]; inverse of the above."""
    B, H, W, Cn = x.shape
    if Cn % (n * n):
        raise ValueError(f"depth_to_space_n: {Cn} channels are not divisible by {n * n}")
    C = Cn // (n * n)
    x = x.reshape(B, H, W, n, n, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, n * H, n * W, C)
