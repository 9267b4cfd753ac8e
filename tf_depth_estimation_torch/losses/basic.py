"""Elementary loss terms (port of ``tf_depth_estimation_tpu/losses/basic.py``), NHWC."""
from __future__ import annotations

import torch


def second_order_smoothness(pred: torch.Tensor) -> torch.Tensor:
    """Mean |dxx| + |dxdy| + |dydx| + |dyy| of a [B, H, W, C] prediction (ref
    ``compute_smooth_loss``, ``my_losses.py:27-36``): second order, not edge-aware;
    |dxdy| and |dydx| are the same values and the reference sums both."""
    dy = pred[:, 1:] - pred[:, :-1]
    dx = pred[:, :, 1:] - pred[:, :, :-1]
    dx2 = dx[:, :, 1:] - dx[:, :, :-1]
    dxdy = dx[:, 1:] - dx[:, :-1]
    dydx = dy[:, :, 1:] - dy[:, :, :-1]
    dy2 = dy[:, 1:] - dy[:, :-1]
    return dx2.abs().mean() + dxdy.abs().mean() + dydx.abs().mean() + dy2.abs().mean()


def si_log_rmse(label: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """The reference's 'scale-invariant' log RMSE, sqrt(mean(d^2) + mean(d)^2) with
    d = log(label) - log(pred) (validation metric, ``train_depth_only.py:248-249``). The
    reference adds the squared mean where Eigen et al. subtract it, so global scale error
    still counts; kept as it is for parity."""
    d = torch.log(label) - torch.log(pred)
    return torch.sqrt((d * d).mean() + d.mean() ** 2)
