"""The fused bilinear warp sampler: CUDA forward and backward kernels, and the plain version.

``bilinear_sample_fused(imgs, coords)`` takes ``imgs`` [B, Hs, Ws, C] and ``coords``
[B, Ht, Wt, 2] (x, y), float32, and returns ``(out [B, Ht, Wt, C], wmask [B, Ht, Wt, 1])``,
the function of ``ops/bilinear_sample.py`` (the reference border rule). It replaces
``tf_depth_estimation_tpu/ops/pallas_warp.py:144 bilinear_sample_fused`` (kernel
``_warp_kernel`` at ``:51``) and keeps its eligibility rule word for word
(``_supported``, ``pallas_warp.py:93-96``): ``Ht * Wt == Hs * Ws``, ``B % 8 == 0`` and
``Hs * Ws <= 131072``. The rule compares products, not shapes, so a 16x24 image sampled
at 24x16 coords is eligible.

* On a CUDA tensor, an eligible call launches ``csrc/bilinear_sample_fused.cu``: a forward
  that writes ``out`` and ``wmask`` and nothing else (``bilinear_sample_fused.launches``),
  and a backward that recomputes the four taps and writes ``dcoords`` (and ``dimgs``,
  scattered with atomics, when the image needs a gradient;
  ``bilinear_sample_fused.backward_launches``). An ineligible call goes to the sampler
  kernel of ``ops/bilinear_sample.py`` (``bilinear_sample.launches``), where JAX falls
  back to its plain sampler: that kernel computes the plain sampler bit for bit.
  Either launches its kernel or raises.
* On a CPU tensor the call is ``bilinear_sample_reference``, the plain version, under
  autograd, as JAX's backward is autodiff of its plain sampler (``pallas_warp.py:153-156``).

The wrapper makes ``imgs`` and ``coords`` contiguous (the warps' coordinates may arrive as
views) and takes float32 only. A gradient of ``wmask`` may be absent: config 3 never reads
the mask, and an absent gradient is read as zeros without being made.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
from torch.autograd.function import once_differentiable

from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.bilinear_sample import (
    _check,
    bilinear_sample,
    bilinear_sample_reference,
)

_S = 8               # batch multiple of the JAX kernel's blocks (pallas_warp.py:45)
_MAX_HW = 131072     # its flat-image limit (pallas_warp.py:46)


def _supported(imgs: torch.Tensor, coords: torch.Tensor) -> bool:
    """JAX's rule (``pallas_warp.py:93-96``): a same-size warp, B % 8 == 0 and a flat
    image of at most 131,072 pixels."""
    B, Hs, Ws, C = imgs.shape
    _, Ht, Wt, _ = coords.shape
    return (Ht * Wt == Hs * Ws) and (B % _S == 0) and (Hs * Ws <= _MAX_HW)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(imgs: torch.Tensor, coords: torch.Tensor):
    B, Hs, Ws, C = imgs.shape
    _, Ht, Wt, _ = coords.shape
    out = torch.empty((B, Ht, Wt, C), dtype=torch.float32, device=imgs.device)
    wmask = torch.empty((B, Ht, Wt, 1), dtype=torch.float32, device=imgs.device)
    with torch.cuda.device(imgs.device):
        err = _lib().bilinear_sample_fused_forward_launch(
            imgs.data_ptr(), coords.data_ptr(), out.data_ptr(), wmask.data_ptr(), B, Hs,
            Ws, Ht, Wt, C, _stream(imgs))
    if err != 0:
        raise RuntimeError(f"bilinear_sample_fused_forward_launch failed: cudaError_t {err}")
    bilinear_sample_fused.launches += 1
    return out, wmask


def _launch_backward(imgs, coords, dout, dwmask, want_dimgs: bool, want_dcoords: bool):
    B, Hs, Ws, C = imgs.shape
    _, Ht, Wt, _ = coords.shape
    kw = dict(dtype=torch.float32, device=imgs.device)
    dcoords = torch.empty((B, Ht, Wt, 2), **kw) if want_dcoords else None
    dimgs = torch.zeros((B, Hs, Ws, C), **kw) if want_dimgs else None
    ptr = lambda t: None if t is None else t.data_ptr()
    dout = None if dout is None else dout.to(torch.float32).contiguous()
    dwmask = None if dwmask is None else dwmask.to(torch.float32).contiguous()
    with torch.cuda.device(imgs.device):
        err = _lib().bilinear_sample_fused_backward_launch(
            imgs.data_ptr(), coords.data_ptr(), ptr(dout), ptr(dwmask), ptr(dcoords),
            ptr(dimgs), B, Hs, Ws, Ht, Wt, C, _stream(imgs))
    if err != 0:
        raise RuntimeError(f"bilinear_sample_fused_backward_launch failed: cudaError_t {err}")
    bilinear_sample_fused.backward_launches += 1
    return dimgs, dcoords


class _FusedSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, coords):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(imgs, coords)
        return _launch_forward(imgs, coords)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dwmask):
        imgs, coords = ctx.saved_tensors
        want_dimgs, want_dcoords = ctx.needs_input_grad[:2]
        if (dout is None and dwmask is None) or not (want_dimgs or want_dcoords):
            return None, None
        return _launch_backward(imgs, coords, dout, dwmask, want_dimgs, want_dcoords)


def bilinear_sample_fused(imgs: torch.Tensor, coords: torch.Tensor):
    """(out [B,Ht,Wt,C], wmask [B,Ht,Wt,1]) from float32 ``imgs`` [B,Hs,Ws,C] and
    ``coords`` [B,Ht,Wt,2]. On a CUDA tensor this launches the fused kernels, or the
    sampler kernel of ``ops/bilinear_sample.py`` for a call outside JAX's rule, or
    raises; on a CPU tensor it is the plain version."""
    imgs, coords = imgs.contiguous(), coords.contiguous()
    _check(imgs, coords)
    if not imgs.is_cuda:
        return bilinear_sample_reference(imgs, coords)
    if not _supported(imgs, coords):
        return bilinear_sample(imgs, coords)
    return _FusedSample.apply(imgs, coords)


bilinear_sample_fused.launches = 0
bilinear_sample_fused.backward_launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bilinear_sample_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilinear_sample_fused_forward_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.bilinear_sample_fused_forward_launch.restype = i
    lib.bilinear_sample_fused_backward_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                                          i, p]
    lib.bilinear_sample_fused_backward_launch.restype = i
    return lib
