"""TF1-legacy image resizes on NCHW tensors: bilinear, area, nearest.

The reference uses TF1's legacy resize semantics (align_corners=False and no half-pixel
centres: ``src = dst * in/out``). ``F.interpolate`` uses half-pixel centres and does not
match, so each resize is built from the same separable weight matrices as
``tf_depth_estimation_tpu/ops/resize.py``: ``out = W_h @ img @ W_w^T`` over the last two
axes. Exact x2 bilinear upsamples and integer nearest upscales take the same stencil and
repeat shortcuts as the JAX functions.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch


@lru_cache(maxsize=None)
def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] TF1 align_corners=False bilinear weights (src = dst * in/out)."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        frac = src - lo
        lo = min(lo, in_size - 1)
        hi = min(lo + 1, in_size - 1)
        W[i, lo] += 1.0 - frac
        W[i, hi] += frac
    return W


@lru_cache(maxsize=None)
def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] TF1 ``resize_area`` weights: mean over [i*s, (i+1)*s) with fractional
    edge coverage, normalized by the box size."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        left = i * scale
        right = (i + 1) * scale
        lo = int(np.floor(left))
        hi = int(np.ceil(right))
        for j in range(lo, hi):
            cover = min(right, j + 1) - max(left, j)
            W[i, min(j, in_size - 1)] += cover
        W[i] /= scale
    return W


@lru_cache(maxsize=None)
def _nearest_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] TF1 ``resize_nearest_neighbor`` (align_corners=False) selection matrix."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        W[i, min(int(np.floor(i * scale)), in_size - 1)] = 1.0
    return W


def _resize(img: torch.Tensor, size: Sequence[int], weight_fn) -> torch.Tensor:
    H, W = img.shape[-2:]
    as_t = lambda m: torch.from_numpy(m).to(device=img.device, dtype=img.dtype)
    Wh = as_t(weight_fn(H, int(size[0])))
    Ww = as_t(weight_fn(W, int(size[1])))
    return Wh @ img @ Ww.T


def _up2_bilinear(img: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact TF1 x2 bilinear along ``dim``: out[2k] = in[k], out[2k+1] = (in[k]+in[k+1])/2
    with the last tap clamped; the rows of ``_bilinear_weights(n, 2n)``."""
    dim %= img.dim()
    n = img.shape[dim]
    nxt = torch.cat([img.narrow(dim, 1, n - 1), img.narrow(dim, n - 1, 1)], dim)
    odd = 0.5 * (img + nxt)
    shape = list(img.shape)
    shape[dim] *= 2
    return torch.stack([img, odd], dim + 1).reshape(shape)


def resize_bilinear(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF1 ``resize_bilinear(align_corners=False)``. img: [B, C, H, W]."""
    H, W = img.shape[-2:]
    out_h, out_w = int(size[0]), int(size[1])
    if (H, W) == (out_h, out_w):
        return img
    if (out_h, out_w) == (2 * H, 2 * W):
        return _up2_bilinear(_up2_bilinear(img, -2), -1)
    return _resize(img, size, _bilinear_weights)


def resize_area(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF1 ``resize_area``. img: [B, C, H, W]. An integer downscale factor is an exact
    average pool (reshape and mean, as the JAX function takes it); other ratios take the
    separable area weights."""
    B, C, H, W = img.shape
    out_h, out_w = int(size[0]), int(size[1])
    if (H, W) == (out_h, out_w):
        return img
    if out_h and out_w and H % out_h == 0 and W % out_w == 0:
        return img.reshape(B, C, out_h, H // out_h, out_w, W // out_w).mean((3, 5))
    return _resize(img, size, _area_weights)


def resize_nearest(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF1 ``resize_nearest_neighbor(align_corners=False)``. img: [B, C, H, W]."""
    H, W = img.shape[-2:]
    out_h, out_w = int(size[0]), int(size[1])
    if (H, W) == (out_h, out_w):
        return img
    if out_h % H == 0 and out_w % W == 0:
        return img.repeat_interleave(out_h // H, -2).repeat_interleave(out_w // W, -1)
    return _resize(img, size, _nearest_weights)


def resize_like(inputs: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Nearest-resize ``inputs`` to ``ref``'s spatial size where they differ (the
    reference's patch for odd-size deconv mismatches)."""
    if inputs.shape[-2:] == ref.shape[-2:]:
        return inputs
    return resize_nearest(inputs, ref.shape[-2:])
