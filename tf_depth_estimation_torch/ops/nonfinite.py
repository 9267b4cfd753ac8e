"""Non-finite replacement with gradient masking (port of
``tf_depth_estimation_tpu/ops/nonfinite.py``, the reference's
``lmbspecialops.replace_nonfinite``, ``my_losses.py:87,211``).

NaN and +-Inf entries become ``value`` and their gradient is 0: an explicit backward, so
that a NaN cotangent arriving at a masked entry is dropped too, as JAX's custom VJP
(``nonfinite.py:17-32``) drops it.
"""
from __future__ import annotations

import torch


class _ReplaceNonfinite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, value):
        mask = torch.isfinite(x)
        ctx.save_for_backward(mask)
        return torch.where(mask, x, torch.full_like(x, value))

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None


def replace_nonfinite(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Replace NaN/+-Inf entries of ``x`` with ``value``; the gradient is zero there."""
    return _ReplaceNonfinite.apply(x, float(value))
