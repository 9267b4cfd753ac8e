"""Second-order smoothness: a CUDA forward and backward, and the plain version.

``smoothness_fused(pred)`` takes a [B, H, W, C] float32 map and returns the scalar
``second_order_smoothness(pred)`` (the plain version, in ``losses/basic.py``):
mean |dxx| + mean |dyy| + mean |dxdy| + mean |dydx|, each mean over its own valid count,
the sum averaged over the batch. It replaces
``tf_depth_estimation_tpu/ops/pallas_losses.py:182 smoothness_fused`` (kernel
``_smooth_kernel`` at ``:140``) and keeps its eligibility rule (``_smooth_fused_impl``,
``:162-165``): where C != 1, H < 3 or W < 3 the result is the plain term.

On an eligible CUDA tensor the forward launches ``csrc/smoothness.cu`` (two kernels:
block partials and their sum in a fixed order) and the backward one gather kernel; each
counts its launches (``smoothness_fused.launches`` and ``.backward_launches``) or raises.
The map is read in place through its strides, so a C=1 channel of an NCHW head viewed
NHWC needs no copy. On a CPU tensor the plain version runs under autograd. Only float32
is accepted.

``smoothness_backward_reference`` is the backward kernel's formula in plain PyTorch, in
gather form: each pixel adds ``ct * sgn(term) / (B * count)`` for every term that reads
it, with weights (1, -2, 1) for dxx and dyy and (1, -1, -1, 1) for the mixed terms. The
tests hold it against autograd.

At an exact tie (a term that is 0, as a constant or bf16-quantised map gives) the
derivative of |t| is taken as 0, as PyTorch's ``abs`` backward and TF1's take it. JAX's
is +1 there (its JVP selects on t >= 0), so the JAX package's gradient differs from the
port's at ties and only there; ``tests/test_torch_depth_only.py`` shows both.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tf_depth_estimation_torch.losses.basic import second_order_smoothness
from tf_depth_estimation_torch.ops import _build


def _terms(x: torch.Tensor):
    """(dxx, dyy, dxdy, dydx) of x [B, H, W], each formed as the plain version forms it."""
    dx = x[:, :, 1:] - x[:, :, :-1]
    dy = x[:, 1:] - x[:, :-1]
    return (dx[:, :, 1:] - dx[:, :, :-1], dy[:, 1:] - dy[:, :-1], dx[:, 1:] - dx[:, :-1],
            dy[:, :, 1:] - dy[:, :, :-1])


def smoothness_backward_reference(pred: torch.Tensor, ct: torch.Tensor,
                                  sign=torch.sign) -> torch.Tensor:
    """d smoothness / d pred for an eligible [B, H, W, 1] map and the scalar cotangent
    ``ct``, in the backward kernel's gather form and sum order; returns [B, H, W, 1].
    ``sign`` is the derivative of |t| (the kernel's: ``torch.sign``, 0 at t = 0)."""
    x = pred[..., 0]
    B, H, W = x.shape
    txx, tyy, txy, tyx = (sign(t) for t in _terms(x))
    # pad each sign map so that pixel (i, j) reads the terms at (i, j - k) / (i - k, j)
    pxx = F.pad(txx, (2, 2))                 # [B, H, W + 2]: term j' at index j' + 2
    a_xx = pxx[:, :, 2:W + 2] - 2 * pxx[:, :, 1:W + 1] + pxx[:, :, 0:W]
    pyy = F.pad(tyy, (0, 0, 2, 2))
    a_yy = pyy[:, 2:H + 2] - 2 * pyy[:, 1:H + 1] + pyy[:, 0:H]

    def mixed(t):                            # [B, H-1, W-1] -> [B, H, W]
        p = F.pad(t, (1, 1, 1, 1))           # term (i', j') at (i' + 1, j' + 1)
        return (p[:, 1:H + 1, 1:W + 1] - p[:, 1:H + 1, 0:W] - p[:, 0:H, 1:W + 1]
                + p[:, 0:H, 0:W])

    g_xx = ct / (B * H * (W - 2))
    g_yy = ct / (B * (H - 2) * W)
    g_m = ct / (B * (H - 1) * (W - 1))
    g = a_xx * g_xx + a_yy * g_yy + mixed(txy) * g_m + mixed(tyx) * g_m
    return g[..., None]


def _eligible(pred: torch.Tensor) -> bool:
    """JAX's rule: the kernel takes C = 1 maps of at least 3 x 3."""
    _, H, W, C = pred.shape
    return C == 1 and H >= 3 and W >= 3


def _check(pred: torch.Tensor) -> None:
    if pred.dim() != 4:
        raise ValueError(f"smoothness_fused takes pred [B,H,W,C], got {tuple(pred.shape)}")
    if pred.dtype != torch.float32:
        raise TypeError(f"smoothness_fused takes float32, got {pred.dtype}")
    if pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"smoothness_fused runs on CUDA or CPU tensors, not {pred.device}")


def _plane(pred: torch.Tensor):
    """(B, H, W, batch stride, row stride, column stride) of a [B, H, W, 1] map."""
    B, H, W, _ = pred.shape
    sb, sh, sw, _ = pred.stride()
    return B, H, W, sb, sh, sw


def _launch_forward(pred: torch.Tensor) -> torch.Tensor:
    B, H, W, sb, sh, sw = _plane(pred)
    lib = _lib()
    partials = torch.empty((B * lib.smoothness_blocks(H, W) * 4,), dtype=torch.float32,
                           device=pred.device)
    out = torch.empty((), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        err = lib.smoothness_forward_launch(pred.data_ptr(), B, H, W, sb, sh, sw,
                                            partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"smoothness_forward_launch failed: cudaError_t {err}")
    smoothness_fused.launches += 1
    return out


def _launch_backward(pred: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    B, H, W, sb, sh, sw = _plane(pred)
    ct = ct.to(torch.float32).contiguous()
    dx = torch.empty((B, H, W, 1), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        err = _lib().smoothness_backward_launch(pred.data_ptr(), B, H, W, sb, sh, sw,
                                                ct.data_ptr(), dx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"smoothness_backward_launch failed: cudaError_t {err}")
    smoothness_fused.backward_launches += 1
    return dx


class _Smoothness(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred):
        ctx.save_for_backward(pred)
        return _launch_forward(pred)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        (pred,) = ctx.saved_tensors
        return _launch_backward(pred, ct)


def smoothness_fused(pred: torch.Tensor) -> torch.Tensor:
    """The scalar second-order smoothness of float32 ``pred`` [B, H, W, C]. On an eligible
    CUDA tensor this launches the kernels or raises; elsewhere it is the plain term."""
    _check(pred)
    if pred.is_cuda and _eligible(pred):
        return _Smoothness.apply(pred)
    return second_order_smoothness(pred)


smoothness_fused.launches = 0
smoothness_fused.backward_launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("smoothness")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.smoothness_blocks.argtypes = [i, i]
    lib.smoothness_blocks.restype = i
    lib.smoothness_forward_launch.argtypes = [p, i, i, i, ll, ll, ll, p, p, p]
    lib.smoothness_forward_launch.restype = i
    lib.smoothness_backward_launch.argtypes = [p, i, i, i, ll, ll, ll, p, p, p]
    lib.smoothness_backward_launch.restype = i
    return lib
