"""slim-semantics conv building blocks on NCHW tensors.

The reference's layers are ``slim.conv2d`` / ``slim.conv2d_transpose`` with TF ``SAME``
padding, a batch norm with epsilon 1e-3 and no scale, glorot-uniform init and no conv bias
where a batch norm follows (``tf_depth_estimation_tpu/models/layers.py``). Two places
differ from PyTorch's own layers and are written out here:

* TF ``SAME`` pads unevenly: a stride-2 conv on an even size puts the odd pixel of padding
  at the bottom and right (7x7/s2 pads 2 on top and 3 below), so ``padding=k//2`` would
  shift every output.
* ``tf.nn.conv2d_transpose`` SAME with a ``[kh, kw, out, in]`` kernel is the adjoint of a
  TF SAME conv; as ``conv_transpose2d`` it has no padding, and of the ``kernel - stride``
  extra rows (columns) it crops ``(kernel - stride) // 2`` at the top (left), the SAME
  conv's leading pad, and the rest at the bottom (right): 0 and 1 for DispNet's 3x3
  kernels, 1 and 2 for a 5x5 and 2 and 3 for a 7x7 (DepthPoseNet's explainability
  decoder). Its kernel needs no flip, only the axes permuted to ``[in, out, kh, kw]``.

Parameters stay float32; a layer computes in its input's dtype and casts its weights to
it, as flax does with ``dtype=bfloat16`` and ``param_dtype=float32``.

Inside ``sync_batch_norm(group)`` a train-mode ``SlimBatchNorm`` takes its batch
statistics over the whole batch of every rank of ``group`` (``parallel/``): JAX's
data-parallel step gets the same from XLA, which partitions the batch norm of a sharded
batch with cross-device reductions (``tf_depth_estimation_tpu/parallel/mesh.py:51-55``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
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
    top, left = max(w.shape[-2] - stride, 0) // 2, max(w.shape[-1] - stride, 0) // 2
    return y[..., top: top + stride * H, left: left + stride * W]


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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d_same(x, self.weight.to(x.dtype), bias, self.stride)


class TFConvTranspose(nn.Module):
    """``tf.nn.conv2d_transpose`` SAME; ``weight`` is [in, out, kh, kw], and an optional
    ``bias``."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2,
                 generator: Optional[torch.Generator] = None, bias: bool = False):
        super().__init__()
        self.stride = stride
        # glorot fans of the TF variable [k, k, out, in], as slim computes them
        self.weight = nn.Parameter(
            _glorot((cin, cout, k, k), cout * k * k, cin * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv_transpose2d_same(x, self.weight.to(x.dtype), bias, self.stride)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a process group, with the sum of the cotangents as the
    backward: each rank's loss reaches every rank's input through the shared sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


_NO_SYNC = object()
_sync_group = _NO_SYNC   # the group of the enclosing sync_batch_norm, if any


@contextlib.contextmanager
def sync_batch_norm(group=None):
    """Train-mode batch norms inside share their batch statistics over ``group`` (None:
    the default process group)."""
    global _sync_group
    saved, _sync_group = _sync_group, group
    try:
        yield
    finally:
        _sync_group = saved


def bn_affine(bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
    """(scale, shift) of the eval slim batch norm, float32: ``x * scale + shift``."""
    s = torch.rsqrt(var.float() + BN_EPS)
    return s, bias.float() - mean.float() * s


class SlimBatchNorm(nn.Module):
    """slim batch norm with flax's arithmetic: epsilon 1e-3, a bias and no scale.

    Eval: ``(x - mean) * rsqrt(var + 1e-3) + bias`` with the running statistics.
    Train: the batch statistics over (N, H, W) in float32, ``var = max(E[x^2] - E[x]^2,
    0)`` (flax's biased "fast" variance), the normalisation in float32 and the result cast
    back to the input's dtype; inside ``sync_batch_norm`` the per-channel sums of x and
    x^2 and the count are summed over the process group first, so that every rank
    normalises by the statistics of the global batch; the running statistics move as
    flax moves them, ``r = m * r + (1 - m) * batch`` with ``m`` the decay (``momentum``:
    0.99 for depth4, 0.999 for depth10_flow). ``nn.BatchNorm2d`` would update with the unbiased variance,
    and its ``momentum`` is ``1 - m``.
    """

    def __init__(self, c: int, momentum: float = 0.99):
        super().__init__()
        self.momentum = momentum
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def affine(self):
        """(scale, shift) of the eval transform, float32."""
        return bn_affine(self.bias, self.running_mean, self.running_var)

    def forward(self, x):
        if not self.training:
            s, t = self.affine()
            return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]
        if x.numel() == 0:   # an empty batch would write NaN into the running statistics
            raise ValueError(f"train-mode batch norm needs a non-empty batch, got "
                             f"{tuple(x.shape)}")
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if _sync_group is not _NO_SYNC:
            c = x.shape[1]
            sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                              xf.new_tensor([x.numel() // c])])
            sums = _AllReduceSum.apply(sums, _sync_group)
            mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        else:
            mean, mean_sq = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
        y = y + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y.to(x.dtype)


class SlimConv(nn.Module):
    """conv (or TF transposed conv) -> slim batch norm -> ReLU, or without the ReLU
    (``relu=False``: TurboDepthNet's laterals and upsamples). ``use_bn=False`` is JAX's
    ``SlimConv(use_bn=False)`` with its ReLU: the conv takes a bias (``conv.bias``) and
    no batch norm follows (``bn`` is None; depth4_nobn DispNet). A linear head, a conv
    with a bias and neither, is ``TFConv2d(..., bias=True)`` in every port net, with the
    weight bridge's ``<layer>.weight`` / ``<layer>.bias`` names."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 transpose: bool = False, generator: Optional[torch.Generator] = None,
                 bn_momentum: float = 0.99, relu: bool = True, use_bn: bool = True):
        super().__init__()
        self.conv = (TFConvTranspose(cin, cout, k, stride, generator, bias=not use_bn)
                     if transpose else
                     TFConv2d(cin, cout, k, stride, bias=not use_bn, generator=generator))
        self.bn = SlimBatchNorm(cout, bn_momentum) if use_bn else None
        self.relu = relu

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return torch.relu(y) if self.relu else y
