"""slim-semantics conv building blocks on NCHW tensors.

The reference's layers are ``slim.conv2d`` / ``slim.conv2d_transpose`` with TF ``SAME``
padding, a batch norm with epsilon 1e-3 and no scale, glorot-uniform init and no conv bias
where a batch norm follows (``tf_depth_estimation_tpu/models/layers.py``). Two places
differ from PyTorch's own layers and are written out here:

* TF ``SAME`` pads unevenly: a stride-2 conv on an even size puts the odd pixel of padding
  at the bottom and right (7x7/s2 pads 2 on top and 3 below), so ``padding=k//2`` would
  shift every output.
* ``tf.nn.conv2d_transpose`` SAME with a ``[kh, kw, out, in]`` kernel is the adjoint of a
  TF SAME conv; as ``conv_transpose2d`` it has no padding and the trailing
  ``kernel - stride`` rows and columns cropped. Its kernel needs no flip, only the axes
  permuted to ``[in, out, kh, kw]``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def _same_pads(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """TF ``SAME`` conv. x: [B, Ci, H, W]; w: [Co, Ci, kh, kw]."""
    top, bottom = _same_pads(x.shape[-2], w.shape[-2], stride)
    left, right = _same_pads(x.shape[-1], w.shape[-1], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, bias, stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, bias, stride)


def conv_transpose2d_same(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 2) -> torch.Tensor:
    """``tf.nn.conv2d_transpose`` SAME: output ``stride * input``. w: [Ci, Co, kh, kw]."""
    H, W = x.shape[-2:]
    y = F.conv_transpose2d(x, w, bias, stride)
    return y[..., : stride * H, : stride * W]


def _glorot(shape, fan_in: int, fan_out: int, generator):
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class TFConv2d(nn.Module):
    """TF ``SAME`` conv with an OIHW ``weight`` and an optional ``bias``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            _glorot((cout, cin, k, k), cin * k * k, cout * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv2d_same(x, self.weight, self.bias, self.stride)


class TFConvTranspose(nn.Module):
    """``tf.nn.conv2d_transpose`` SAME; ``weight`` is [in, out, kh, kw]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        # glorot fans of the TF variable [k, k, out, in], as slim computes them
        self.weight = nn.Parameter(
            _glorot((cin, cout, k, k), cout * k * k, cin * k * k, generator))

    def forward(self, x):
        return conv_transpose2d_same(x, self.weight, None, self.stride)


def bn_affine(bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
    """(scale, shift) of the eval slim batch norm, float32: ``x * scale + shift``."""
    s = torch.rsqrt(var.float() + BN_EPS)
    return s, bias.float() - mean.float() * s


class SlimBatchNorm(nn.Module):
    """Eval-mode slim batch norm: ``(x - mean) * rsqrt(var + 1e-3) + bias``, no scale.

    Train-mode statistics (flax's biased variance, decay 0.99) come with the training
    slice; until then a module in train mode raises rather than silently using the
    running statistics.
    """

    def __init__(self, c: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def affine(self):
        """(scale, shift) of the eval transform, float32."""
        return bn_affine(self.bias, self.running_mean, self.running_var)

    def forward(self, x):
        if self.training:
            raise NotImplementedError("train-mode batch norm is not ported yet")
        s, t = self.affine()
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


class SlimConv(nn.Module):
    """conv (or TF transposed conv) -> slim batch norm -> ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 transpose: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = (TFConvTranspose(cin, cout, k, stride, generator) if transpose
                     else TFConv2d(cin, cout, k, stride, generator=generator))
        self.bn = SlimBatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))
