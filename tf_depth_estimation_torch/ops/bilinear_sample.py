"""Bilinear sampling with the reference border rule: a CUDA kernel and its plain version.

``bilinear_sample(imgs, coords)`` samples ``imgs`` [B, Hs, Ws, C] float32 at ``coords``
[B, Ht, Wt, 2] float32 (x, y) and returns ``(out [B, Ht, Wt, C], wmask [B, Ht, Wt, 1])``:

    x0 = floor(x), x1 = x0 + 1 (y alike), each clamped to the image for the gather;
    wx0 = (x1 - x) * [x0 inside], wx1 = (x - x0) * [x1 inside]   (wy alike)
    out = w00*im00 + w01*im01 + w10*im10 + w11*im11,  w_ab = wx_a * wy_b
    wmask = w00 + w01 + w10 + w11

It replaces ``tf_depth_estimation_tpu/ops/pallas_sample.py:255 bilinear_sample_tpu``
(kernel ``_sample_kernel`` at ``:97`` behind the XLA prologue ``_prologue`` at ``:69``).
On a CUDA tensor the forward launches ``csrc/bilinear_sample.cu`` (and counts the launch
in ``bilinear_sample.launches``) or raises; on a CPU tensor it runs the plain gathers of
``bilinear_sample_reference``. The kernel takes float32 only.

The backward is plain PyTorch, as the JAX VJP (``pallas_sample.py:269-310``) is XLA code:
like it, the forward saves the four corner planes (the kernel writes them when the coords
need a gradient), so ``dcoords`` is elementwise on them; ``dimgs`` is a scatter-add
(``scatter_add_``, atomic and so unordered on the GPU), computed only when the image needs
a gradient. floor and the clamps
have zero gradient, as in both frameworks' autodiff.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from tf_depth_estimation_torch.ops import _build


def _prologue(coords: torch.Tensor, Hs: int, Ws: int):
    """Clamped corner indices, the four weights and the inside masks for an Hs x Ws
    image, as ``_bilinear_sample_jnp`` computes them."""
    cx, cy = coords[..., 0], coords[..., 1]
    x0 = torch.floor(cx)
    x1 = x0 + 1.0
    y0 = torch.floor(cy)
    y1 = y0 + 1.0
    x0s, x1s = x0.clamp(0.0, float(Ws - 1)), x1.clamp(0.0, float(Ws - 1))
    y0s, y1s = y0.clamp(0.0, float(Hs - 1)), y1.clamp(0.0, float(Hs - 1))
    inside = {"x0": (x0 == x0s).to(cx.dtype), "x1": (x1 == x1s).to(cx.dtype),
              "y0": (y0 == y0s).to(cx.dtype), "y1": (y1 == y1s).to(cx.dtype)}
    wx0 = (x1 - cx) * inside["x0"]
    wx1 = (cx - x0) * inside["x1"]
    wy0 = (y1 - cy) * inside["y0"]
    wy1 = (cy - y0) * inside["y1"]
    # the integer clamp only matters for NaN coordinates (NaN weights either way): it
    # keeps their gather inside the image, where the kernel's fminf/fmaxf put it
    idx = lambda v, n: v.long().clamp(0, n - 1)
    ints = {"ix0": idx(x0s, Ws), "ix1": idx(x1s, Ws), "iy0": idx(y0s, Hs),
            "iy1": idx(y1s, Hs)}
    return ints, (wx0, wx1, wy0, wy1), inside


def _flat_index(ints: dict, iy: str, ix: str, Ws: int) -> torch.Tensor:
    B = ints[iy].shape[0]
    return (ints[iy] * Ws + ints[ix]).reshape(B, -1)


def _gather_corners(imgs: torch.Tensor, ints: dict):
    """(im00, im01, im10, im11), each [B, Ht, Wt, C]: integer gathers of the flat image."""
    B, Hs, Ws, C = imgs.shape
    flat = imgs.reshape(B, Hs * Ws, C)
    shape = (*ints["ix0"].shape, C)

    def gather(iy, ix):
        idx = _flat_index(ints, iy, ix, Ws)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(shape)

    return (gather("iy0", "ix0"), gather("iy1", "ix0"), gather("iy0", "ix1"),
            gather("iy1", "ix1"))


def _combine(weights, corners):
    wx0, wx1, wy0, wy1 = weights
    im00, im01, im10, im11 = corners
    w00, w01 = (wx0 * wy0)[..., None], (wx0 * wy1)[..., None]
    w10, w11 = (wx1 * wy0)[..., None], (wx1 * wy1)[..., None]
    out = w00 * im00 + w01 * im01 + w10 * im10 + w11 * im11
    return out, w00 + w01 + w10 + w11


def bilinear_sample_reference(imgs: torch.Tensor, coords: torch.Tensor):
    """The plain PyTorch version (mirrors ``_bilinear_sample_jnp``, ``geometry/
    sampling.py:72-120``), differentiated by autograd. Integer gathers, never
    ``grid_sample``: that normalises the coordinates (a rounding round trip) and has no
    wmask. Counts its calls in ``bilinear_sample_reference.calls``, so that a run can
    show that a path sampled through a kernel and never through this."""
    bilinear_sample_reference.calls += 1
    ints, weights, _ = _prologue(coords, *imgs.shape[1:3])
    return _combine(weights, _gather_corners(imgs, ints))


bilinear_sample_reference.calls = 0


def _check(imgs: torch.Tensor, coords: torch.Tensor) -> None:
    if imgs.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != imgs.shape[0]:
        raise ValueError(f"bilinear_sample takes imgs [B,Hs,Ws,C] and coords [B,Ht,Wt,2], "
                         f"got {tuple(imgs.shape)} and {tuple(coords.shape)}")
    if imgs.shape[1] == 0 or imgs.shape[2] == 0:
        raise ValueError(f"bilinear_sample needs a non-empty image, got {tuple(imgs.shape)}")
    if imgs.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"bilinear_sample takes float32 imgs and coords, got {imgs.dtype} "
                        f"and {coords.dtype}")
    if coords.device != imgs.device:
        raise ValueError(f"coords are on {coords.device}, imgs on {imgs.device}")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bilinear_sample runs on CUDA or CPU tensors, not {imgs.device}")
    if not (imgs.is_contiguous() and coords.is_contiguous()):
        raise ValueError("bilinear_sample takes contiguous imgs and coords")


def _launch(imgs: torch.Tensor, coords: torch.Tensor, corners: bool):
    """The kernel: (out, wmask, corner planes [4, B, Ht, Wt, C] or None)."""
    B, Hs, Ws, C = imgs.shape
    _, Ht, Wt, _ = coords.shape
    kw = dict(dtype=torch.float32, device=imgs.device)
    out = torch.empty((B, Ht, Wt, C), **kw)
    wmask = torch.empty((B, Ht, Wt, 1), **kw)
    cplanes = torch.empty((4, B, Ht, Wt, C), **kw) if corners else None
    if wmask.numel() == 0:
        return out, wmask, cplanes
    lib = _lib()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.bilinear_sample_launch(
            imgs.data_ptr(), coords.data_ptr(), out.data_ptr(), wmask.data_ptr(),
            cplanes.data_ptr() if corners else None, B, Hs, Ws, Ht, Wt, C, stream)
    if err != 0:
        raise RuntimeError(f"bilinear_sample_launch failed: cudaError_t {err}")
    bilinear_sample.launches += 1
    return out, wmask, cplanes


class _BilinearSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, coords):
        want_corners = ctx.needs_input_grad[1]
        if imgs.is_cuda:
            out, wmask, cplanes = _launch(imgs, coords, want_corners)
            corners = tuple(cplanes) if want_corners else ()
        else:
            ints, weights, _ = _prologue(coords, *imgs.shape[1:3])
            corners = _gather_corners(imgs, ints)
            out, wmask = _combine(weights, corners)
            corners = corners if want_corners else ()
        ctx.img_shape = imgs.shape
        ctx.save_for_backward(coords, *corners)
        return out, wmask

    @staticmethod
    def backward(ctx, dout, dwmask):
        coords, *corners = ctx.saved_tensors
        B, Hs, Ws, C = ctx.img_shape
        ints, (wx0, wx1, wy0, wy1), inside = _prologue(coords, Hs, Ws)
        dm = dwmask[..., 0]
        dimgs = dcoords = None
        if ctx.needs_input_grad[1]:
            im00, im01, im10, im11 = corners
            s00 = (dout * im00).sum(-1) + dm
            s01 = (dout * im01).sum(-1) + dm
            s10 = (dout * im10).sum(-1) + dm
            s11 = (dout * im11).sum(-1) + dm
            # d wx0/dx = -[x0 inside], d wx1/dx = [x1 inside] (y alike)
            dx0, dx1, dy0, dy1 = -inside["x0"], inside["x1"], -inside["y0"], inside["y1"]
            dcx = dx0 * wy0 * s00 + dx0 * wy1 * s01 + dx1 * wy0 * s10 + dx1 * wy1 * s11
            dcy = wx0 * dy0 * s00 + wx0 * dy1 * s01 + wx1 * dy0 * s10 + wx1 * dy1 * s11
            dcoords = torch.stack([dcx, dcy], -1)
        if ctx.needs_input_grad[0]:
            flat = torch.zeros((B, Hs * Ws, C), dtype=dout.dtype, device=dout.device)
            for (iy, ix), w in ((("iy0", "ix0"), wx0 * wy0), (("iy1", "ix0"), wx0 * wy1),
                                (("iy0", "ix1"), wx1 * wy0), (("iy1", "ix1"), wx1 * wy1)):
                upd = (w[..., None] * dout).reshape(B, -1, C)
                flat.scatter_add_(1, _flat_index(ints, iy, ix, Ws)[..., None]
                                  .expand(-1, -1, C), upd)
            dimgs = flat.reshape(B, Hs, Ws, C)
        return dimgs, dcoords


def bilinear_sample(imgs: torch.Tensor, coords: torch.Tensor):
    """(out [B,Ht,Wt,C], wmask [B,Ht,Wt,1]) from float32 ``imgs`` [B,Hs,Ws,C] and
    ``coords`` [B,Ht,Wt,2]. On a CUDA tensor this launches the kernel or raises."""
    _check(imgs, coords)
    return _BilinearSample.apply(imgs, coords)


bilinear_sample.launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bilinear_sample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilinear_sample_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.bilinear_sample_launch.restype = i
    return lib
