"""Scale-invariant gradient images and the robust pointwise L2 loss, in plain PyTorch.

The port of ``tf_depth_estimation_tpu/ops/sig.py`` (``lmbspecialops.scale_invariant_gradient``
and ``tfutils.pointwise_l2_loss`` of the reference, ``my_losses.py:78-82``): for each
delta d, forward differences in x and y normalised by the local magnitude sum,

    g_d[f](i) = (f(i+d) - f(i)) / (|f(i+d)| + |f(i)| + eps),

zero where i+d leaves the image, scaled by a per-delta weight and stacked along the
channel axis; the loss is the mean over pixels of ``sqrt(sum_c (pred - gt)^2 + eps)``.
Their composition is the plain version of the CUDA kernel in ``ops/sig_l2.py``. NHWC, as
in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _shifted_diff(f: torch.Tensor, delta: int, axis: int, eps: float) -> torch.Tensor:
    """(f(x+d) - f(x)) / (|f(x+d)| + |f(x)| + eps), zero where x+d is out of range.
    ``f``: [B, H, W, C]; axis 1 (y) or 2 (x)."""
    n = f.shape[axis]
    fwd = torch.roll(f, -min(delta, n), dims=axis)  # the wrapped part is masked below
    g = (fwd - f) / (fwd.abs() + f.abs() + eps)
    shape = [1, 1, 1, 1]
    shape[axis] = n
    valid = (torch.arange(n, device=f.device) + delta < n).reshape(shape)
    return g * valid.to(f.dtype)


def scale_invariant_gradient(f: torch.Tensor, deltas: Sequence[int] = (1, 2, 4, 8, 16),
                             weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
                             epsilon: float = 0.001) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 2 * len(deltas) * C]: (w_d * gx, w_d * gy) per delta, in
    the order of ``deltas``."""
    if len(deltas) != len(weights):
        raise ValueError("deltas and weights must have equal length")
    outs = []
    for d, w in zip(deltas, weights):
        outs += [w * _shifted_diff(f, d, 2, epsilon), w * _shifted_diff(f, d, 1, epsilon)]
    return torch.cat(outs, -1)


def pointwise_l2_loss(pred: torch.Tensor, gt: torch.Tensor,
                      epsilon: float = 1e-6) -> torch.Tensor:
    """mean over pixels of sqrt(sum over channels (pred - gt)^2 + eps), DeMoN's robust L2."""
    d = pred - gt
    return torch.sqrt((d * d).sum(-1) + epsilon).mean()


def sig_l2_plain(pred: torch.Tensor, gt: torch.Tensor, deltas: Sequence[int] = (2,),
                 eps_sig: float = 0.001, eps_l2: float = 1e-6) -> torch.Tensor:
    """``pointwise_l2_loss(sig(pred), sig(gt))`` with unit weights: the plain version of
    ``sig_l2_fused`` (JAX ``_sig_jnp_ref``, ``ops/pallas_losses.py:99``)."""
    weights = tuple(1.0 for _ in deltas)
    return pointwise_l2_loss(scale_invariant_gradient(pred, deltas, weights, eps_sig),
                             scale_invariant_gradient(gt, deltas, weights, eps_sig), eps_l2)
