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


def reference_explain_mask(batch: int, height: int, width: int, scale: int,
                           device=None) -> torch.Tensor:
    """The all-(0, 1) target of the explainability regulariser at ``scale``
    (``my_losses.py:14-23``): [B, H/2^s, W/2^s, 2]."""
    h, w = int(height / 2**scale), int(width / 2**scale)
    return torch.tensor([0.0, 1.0], device=device).expand(batch, h, w, 2)


def explain_reg_loss(logits: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy of [..., 2] mask logits against ``ref``
    (``my_losses.py:39-43``)."""
    logp = torch.log_softmax(logits.reshape(-1, 2), -1)
    return -(ref.reshape(-1, 2) * logp).sum(-1).mean()
