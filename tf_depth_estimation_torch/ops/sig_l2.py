"""Scale-invariant-gradient L2 loss: a CUDA forward and backward, and the plain version.

``sig_l2_fused(pred, gt, deltas=(2,), eps_sig=1e-3, eps_l2=1e-6)`` takes [B, H, W, C]
float32 maps and returns the scalar
``pointwise_l2_loss(sig(pred, deltas), sig(gt, deltas), eps_l2)`` (the plain version,
``ops/sig.py:sig_l2_plain``): for each delta and axis the normalised forward difference
(f(i+d) - f(i)) / (|f(i+d)| + |f(i)| + eps_sig) of each map, zero where i+d leaves the
image; per pixel sqrt(sum of the squared differences + eps_l2); the mean over pixels. It
replaces ``tf_depth_estimation_tpu/ops/pallas_losses.py:116 sig_l2_fused`` (kernel
``_sig_kernel`` at ``:63``) and keeps its eligibility rule (``_sig_fused_impl``,
``:81-86``): where C != 1 the result is the plain composition.

On a C = 1 CUDA tensor the forward launches ``csrc/sig_l2.cu`` (two kernels: per-pixel
sqrt and block partials, then their sum in a fixed order) and the backward one gather
kernel, which also writes the gradient of ``gt`` when ``gt`` needs one; each counts its
launches (``sig_l2_fused.launches`` and ``.backward_launches``) or raises. The maps are
read in place through their strides, so a C = 1 head of an NCHW tensor viewed NHWC needs
no copy. On a CPU tensor the plain version runs under autograd. Only float32 is taken.

``sig_l2_backward_reference`` is the backward kernel's formula in plain PyTorch, in
gather form and in the kernel's order of operations; the tests hold it against autograd
of the plain version.

The derivative of |f| in a denominator is taken as sgn(f) with sgn(0) = 0, as PyTorch's
``abs`` backward takes it (JAX's is +1 at 0). The training path feeds inverse depths and
depths, which are positive, so f = 0 does not arise there.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.sig import sig_l2_plain

MAX_DELTAS = 8  # csrc/sig_l2.cu MAX_DELTAS


def _axis_terms(f: torch.Tensor, d: int, axis: int):
    """(origin values, end values) of the terms of delta ``d`` along ``axis`` (2: x, 1:
    y) of f [B, H, W]; empty when d is not shorter than the axis."""
    n = f.shape[axis]
    return f.narrow(axis, 0, max(n - d, 0)), f.narrow(axis, min(d, n), max(n - d, 0))


def _pad(t: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """Zero-pad [B, H, W] ``t`` along ``axis`` (2: x, 1: y)."""
    return F.pad(t, (before, after) if axis == 2 else (0, 0, before, after))


def _sig(a: torch.Tensor, e: torch.Tensor, eps: float):
    """(gq, denominator) of the terms from origin values a to end values e."""
    v = (e.abs() + a.abs()) + eps
    return (e - a) / v, v


def sig_l2_backward_reference(pred: torch.Tensor, gt: torch.Tensor, ct: torch.Tensor,
                              deltas: Sequence[int] = (2,), eps_sig: float = 0.001,
                              eps_l2: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d loss / d pred, d loss / d gt), each [B, H, W, 1], for C = 1 maps and the scalar
    cotangent ``ct``, in the backward kernel's gather form and order: acc summed term by
    term (x before y for each delta), s = sqrt(acc + eps_l2), q = (ct / (B H W)) / s at
    the term's origin, w = (gp - gg) q, and each pixel adds its origin-term and end-term
    contributions in the order of the deltas, x then y."""
    p, g = pred[..., 0], gt[..., 0]
    B, H, W = p.shape
    axes = [(d, axis) for d in deltas for axis in (2, 1)]
    acc = torch.zeros_like(p)
    for d, axis in axes:
        if d < p.shape[axis]:
            (pa, pe), (ga, ge) = _axis_terms(p, d, axis), _axis_terms(g, d, axis)
            diff = _sig(pa, pe, eps_sig)[0] - _sig(ga, ge, eps_sig)[0]
            acc = acc + _pad(diff * diff, axis, 0, d)
    q = (ct / (B * H * W)) / torch.sqrt(acc + eps_l2)
    dp, dg = torch.zeros_like(p), torch.zeros_like(g)
    for d, axis in axes:
        if d >= p.shape[axis]:
            continue
        (pa, pe), (ga, ge) = _axis_terms(p, d, axis), _axis_terms(g, d, axis)
        gp, vp = _sig(pa, pe, eps_sig)
        gg, vg = _sig(ga, ge, eps_sig)
        w = (gp - gg) * _axis_terms(q, d, axis)[0]
        # the term's origin (this pixel at i) ...
        dp = dp + _pad(-((w * (1 + gp * torch.sign(pa))) / vp), axis, 0, d)
        dg = dg + _pad((w * (1 + gg * torch.sign(ga))) / vg, axis, 0, d)
        # ... and its end (this pixel at i + d); both pads add exact zeros elsewhere
        dp = dp + _pad((w * (1 - gp * torch.sign(pe))) / vp, axis, d, 0)
        dg = dg + _pad(-((w * (1 - gg * torch.sign(ge))) / vg), axis, d, 0)
    return dp[..., None], dg[..., None]


def _check(pred: torch.Tensor, gt: torch.Tensor, deltas: Tuple[int, ...]) -> None:
    if pred.dim() != 4 or pred.shape != gt.shape:
        raise ValueError(f"sig_l2_fused takes pred and gt [B,H,W,C] of one shape, got "
                         f"{tuple(pred.shape)} and {tuple(gt.shape)}")
    if pred.dtype != torch.float32 or gt.dtype != torch.float32:
        raise TypeError(f"sig_l2_fused takes float32, got {pred.dtype} and {gt.dtype}")
    if pred.device != gt.device or pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sig_l2_fused runs on CUDA or CPU tensors on one device, not "
                         f"{pred.device} and {gt.device}")
    if not 1 <= len(deltas) <= MAX_DELTAS or min(deltas) < 1:
        raise ValueError(f"sig_l2_fused takes 1 to {MAX_DELTAS} deltas of at least 1, got "
                         f"{deltas}")


def _plane(x: torch.Tensor):
    """(pointer, batch stride, row stride, column stride) of a [B, H, W, 1] map."""
    sb, sh, sw, _ = x.stride()
    return x.data_ptr(), sb, sh, sw


def _deltas_arg(deltas: Tuple[int, ...]):
    return (ctypes.c_int * len(deltas))(*deltas), len(deltas)


def _launch_forward(pred, gt, deltas, eps_sig, eps_l2):
    B, H, W, _ = pred.shape
    lib = _lib()
    saved = torch.empty((B, H, W), dtype=torch.float32, device=pred.device)
    partials = torch.empty((B * lib.sig_l2_blocks(H, W),), dtype=torch.float32,
                           device=pred.device)
    out = torch.empty((), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        err = lib.sig_l2_forward_launch(*_plane(pred), *_plane(gt), B, H, W,
                                        *_deltas_arg(deltas), eps_sig, eps_l2,
                                        saved.data_ptr(), partials.data_ptr(),
                                        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sig_l2_forward_launch failed: cudaError_t {err}")
    sig_l2_fused.launches += 1
    return out, saved


def _launch_backward(pred, gt, saved, ct, deltas, eps_sig, need_gt: bool):
    B, H, W, _ = pred.shape
    ct = ct.to(torch.float32).contiguous()
    dp = torch.empty((B, H, W, 1), dtype=torch.float32, device=pred.device)
    dg = torch.empty_like(dp) if need_gt else None
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        err = _lib().sig_l2_backward_launch(
            *_plane(pred), *_plane(gt), B, H, W, *_deltas_arg(deltas), eps_sig,
            saved.data_ptr(), ct.data_ptr(), dp.data_ptr(),
            None if dg is None else dg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sig_l2_backward_launch failed: cudaError_t {err}")
    sig_l2_fused.backward_launches += 1
    return dp, dg


class _SigL2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt, deltas, eps_sig, eps_l2):
        out, saved = _launch_forward(pred, gt, deltas, eps_sig, eps_l2)
        ctx.save_for_backward(pred, gt, saved)
        ctx.deltas, ctx.eps_sig = deltas, eps_sig
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        pred, gt, saved = ctx.saved_tensors
        dp, dg = _launch_backward(pred, gt, saved, ct, ctx.deltas, ctx.eps_sig,
                                  ctx.needs_input_grad[1])
        return (dp if ctx.needs_input_grad[0] else None), dg, None, None, None


def sig_l2_fused(pred: torch.Tensor, gt: torch.Tensor, deltas: Sequence[int] = (2,),
                 eps_sig: float = 0.001, eps_l2: float = 1e-6) -> torch.Tensor:
    """mean over pixels of sqrt(sum over deltas and axes (sig(pred) - sig(gt))^2 + eps_l2)
    for float32 ``pred`` and ``gt`` [B, H, W, C]. On C = 1 CUDA tensors this launches the
    kernels or raises; elsewhere it is the plain composition."""
    deltas = tuple(int(d) for d in deltas)
    _check(pred, gt, deltas)
    if pred.is_cuda and pred.shape[-1] == 1:
        return _SigL2.apply(pred, gt, deltas, float(eps_sig), float(eps_l2))
    return sig_l2_plain(pred, gt, deltas, eps_sig, eps_l2)


sig_l2_fused.launches = 0
sig_l2_fused.backward_launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sig_l2")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.sig_l2_blocks.argtypes = [i, i]
    lib.sig_l2_blocks.restype = i
    lib.sig_l2_forward_launch.argtypes = [p, ll, ll, ll, p, ll, ll, ll, i, i, i, ip, i, f,
                                          f, p, p, p, p]
    lib.sig_l2_forward_launch.restype = i
    lib.sig_l2_backward_launch.argtypes = [p, ll, ll, ll, p, ll, ll, ll, i, i, i, ip, i, f,
                                           p, p, p, p, p]
    lib.sig_l2_backward_launch.restype = i
    return lib
