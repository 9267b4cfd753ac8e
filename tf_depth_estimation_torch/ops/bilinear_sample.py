"""Bilinear sampling with the reference border rule: a CUDA forward and backward for a group
of samplings, and the plain version.

``bilinear_sample(imgs, coords)`` samples ``imgs`` [B, Hs, Ws, C] float32 at ``coords``
[B, Ht, Wt, 2] float32 (x, y) and returns ``(out [B, Ht, Wt, C], wmask [B, Ht, Wt, 1])``:

    x0 = floor(x), x1 = x0 + 1 (y alike), each clamped to the image for the gather;
    wx0 = x0 inside ? x1 - x : 0,  wx1 = x1 inside ? x - x0 : 0   (wy alike)
    out = w00*im00 + w01*im01 + w10*im10 + w11*im11,  w_ab = wx_a * wy_b
    wmask = w00 + w01 + w10 + w11

``bilinear_sample_group(imgs, coords)`` takes two lists (up to ``MAX_MEMBERS`` samplings of
any sizes, views allowed) and returns ``(outs, wmasks)``, two lists: a training step's warps
in one call. ``bilinear_sample`` is a group of one. They replace
``tf_depth_estimation_tpu/ops/pallas_sample.py:255 bilinear_sample_tpu`` (kernel
``_sample_kernel`` at ``:97`` behind the XLA prologue ``_prologue`` at ``:69``).

On CUDA tensors a group launches ``csrc/bilinear_sample.cu`` once each way, or raises: the
forward writes every member's out and wmask (``bilinear_sample.launches``), the backward
recomputes the taps and writes dcoords for the members whose coords need a gradient and
scatters dimgs (atomics into a zeroed buffer, so unordered) for those whose image needs one
(``bilinear_sample.backward_launches``); a member that needs neither gets no work, and its
outputs carry no gradient. The outputs of a group are views of one allocation, as are its
gradients. ``ops/bilinear_sample_fused.py`` launches the same kernels under its own counts.
On CPU tensors every member is ``bilinear_sample_reference``, the plain version, under
autograd, as the JAX VJP (``pallas_sample.py:269-310``) is XLA code. floor and the clamps
have zero gradient, as in both frameworks' autodiff.
"""
from __future__ import annotations

import ctypes
import struct
from functools import lru_cache
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from tf_depth_estimation_torch.ops import _build, _launch

MAX_MEMBERS = 16  # csrc/bilinear_sample.cu MAX_MEMBERS
_HEAD = struct.Struct("=ii")                  # csrc/bilinear_sample.cu Group: members, tiles
_MEMBER = struct.Struct("=QQQQQQQQqiiiiiiii8x")  # csrc/bilinear_sample.cu Member, 112 bytes


def _prologue(coords: torch.Tensor, Hs: int, Ws: int):
    """Clamped corner indices and the four weights for an Hs x Ws image, as
    ``_bilinear_sample_jnp`` computes them. A weight is exactly 0 where its unclamped tap
    is outside, whatever the coordinate: JAX's product of a weight and a boolean is a
    select, so a NaN or infinite coordinate gives weights 0 there (out 0, wmask 0,
    dcoords 0), not NaN."""
    cx, cy = coords[..., 0], coords[..., 1]
    x0 = torch.floor(cx)
    x1 = x0 + 1.0
    y0 = torch.floor(cy)
    y1 = y0 + 1.0
    x0s, x1s = x0.clamp(0.0, float(Ws - 1)), x1.clamp(0.0, float(Ws - 1))
    y0s, y1s = y0.clamp(0.0, float(Hs - 1)), y1.clamp(0.0, float(Hs - 1))
    wx0 = torch.where(x0 == x0s, x1 - cx, 0.0)
    wx1 = torch.where(x1 == x1s, cx - x0, 0.0)
    wy0 = torch.where(y0 == y0s, y1 - cy, 0.0)
    wy1 = torch.where(y1 == y1s, cy - y0, 0.0)
    # the integer clamp only matters for NaN coordinates (zero weights either way): it
    # keeps their gather inside the image, where the kernel's fminf/fmaxf put it
    idx = lambda v, n: v.long().clamp(0, n - 1)
    ints = {"ix0": idx(x0s, Ws), "ix1": idx(x1s, Ws), "iy0": idx(y0s, Hs),
            "iy1": idx(y1s, Hs)}
    return ints, (wx0, wx1, wy0, wy1)


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
    ints, weights = _prologue(coords, *imgs.shape[1:3])
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


def check_group(imgs: List[torch.Tensor], coords: List[torch.Tensor]) -> None:
    """``_check`` of every member, and 1 to ``MAX_MEMBERS`` members on one device."""
    if not 1 <= len(imgs) <= MAX_MEMBERS or len(coords) != len(imgs):
        raise ValueError(f"a sampler group takes 1 to {MAX_MEMBERS} images and coords each, "
                         f"got {len(imgs)} and {len(coords)}")
    for i, c in zip(imgs, coords):
        _check(i, c)
        if i.device != imgs[0].device:
            raise ValueError(f"a sampler group takes tensors on one device, got "
                             f"{imgs[0].device} and {i.device}")


def _pixels(coords: torch.Tensor) -> int:
    return coords.shape[0] * coords.shape[1] * coords.shape[2]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _pack(members: Sequence[tuple]) -> bytes:
    """The group for ``csrc/bilinear_sample.cu`` from ``(imgs, coords, out, wmask, dout,
    dwmask, dcoords, dimgs)`` members (the last six may be None). Consecutive members that
    sample one image at coords of one shape form a set whose tiles alternate."""
    tile = _lib().tile
    parts, tiles, k = [], 0, 0
    while k < len(members):
        imgs, coords = members[k][:2]
        key = (imgs.data_ptr(), imgs.shape, coords.shape)
        j = k + 1
        while j < len(members) and (members[j][0].data_ptr(), members[j][0].shape,
                                    members[j][1].shape) == key:
            j += 1
        B, Ht, Wt, _ = coords.shape
        _, Hs, Ws, C = imgs.shape
        n = B * Ht * Wt
        for lane, (i, c, out, wm, dout, dwm, dc, di) in enumerate(members[k:j]):
            cp, dcp = c.data_ptr(), _ptr(dc)
            parts.append(_MEMBER.pack(
                i.data_ptr(), cp, _ptr(out), _ptr(wm), _ptr(dout), _ptr(dwm), dcp, _ptr(di),
                n, Hs, Ws, C, Ht * Wt, tiles, j - k, lane, int(cp % 16 == 0 and dcp % 16 == 0)))
        tiles += (j - k) * -(-n // tile)
        k = j
    return _HEAD.pack(len(members), tiles) + b"".join(parts)


def _views(buf: torch.Tensor, shapes: Sequence[tuple]) -> List[torch.Tensor]:
    """Contiguous views of ``buf`` with the 4-d ``shapes``, one after another, each
    starting on 16 bytes."""
    views, off = [], 0
    for B, H, W, C in shapes:
        views.append(torch.as_strided(buf, (B, H, W, C), (H * W * C, W * C, C, 1), off))
        off += -(-(B * H * W * C) // 4) * 4
    return views


def _size(shapes: Sequence[tuple]) -> int:
    return sum(-(-(B * H * W * C) // 4) * 4 for B, H, W, C in shapes)


class _SampleGroup(torch.autograd.Function):
    """Every member's (out, wmask) on CUDA tensors: one launch each way, counted on
    ``counter.launches`` and ``counter.backward_launches``."""

    @staticmethod
    def forward(ctx, counter, *tensors):
        ctx.set_materialize_grads(False)
        K = len(tensors) // 2
        imgs, coords = tensors[:K], tensors[K:]
        shapes = [(*c.shape[:3], i.shape[3]) for i, c in zip(imgs, coords)]
        shapes += [(*c.shape[:3], 1) for c in coords]
        buf = torch.empty((_size(shapes),), dtype=torch.float32, device=imgs[0].device)
        views = _views(buf, shapes)
        outs, wmasks = views[:K], views[K:]
        live = [(i, c, o, w, None, None, None, None)
                for i, c, o, w in zip(imgs, coords, outs, wmasks) if _pixels(c)]
        if live:
            _launch.run(_lib().bilinear_group_forward_launch, buf.device, _pack(live))
            counter.launches += 1
        need = ctx.needs_input_grad
        for k in range(K):
            if not (need[1 + k] or need[1 + K + k]):
                ctx.mark_non_differentiable(outs[k], wmasks[k])
        ctx.save_for_backward(*imgs, *coords)
        ctx.counter = counter
        return (*outs, *wmasks)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        K = len(grads) // 2
        saved = ctx.saved_tensors
        imgs, coords, need = saved[:K], saved[K:], ctx.needs_input_grad
        f32 = lambda g: None if g is None else g.to(torch.float32).contiguous()
        douts, dwmasks = [f32(g) for g in grads[:K]], [f32(g) for g in grads[K:]]
        want_c = [need[1 + K + k] and (douts[k] is not None or dwmasks[k] is not None)
                  and _pixels(coords[k]) > 0 for k in range(K)]
        want_i = [need[1 + k] and douts[k] is not None and _pixels(coords[k]) > 0
                  for k in range(K)]
        kc = [k for k in range(K) if want_c[k]]
        ki = [k for k in range(K) if want_i[k]]
        if not (kc or ki):
            return (None,) * (1 + 2 * K)
        dev = imgs[0].device
        dcoords, dimgs = [None] * K, [None] * K
        if kc:
            shapes = [tuple(coords[k].shape) for k in kc]
            buf = torch.empty((_size(shapes),), dtype=torch.float32, device=dev)
            for k, v in zip(kc, _views(buf, shapes)):
                dcoords[k] = v
        if ki:
            shapes = [tuple(imgs[k].shape) for k in ki]
            buf = torch.zeros((_size(shapes),), dtype=torch.float32, device=dev)
            for k, v in zip(ki, _views(buf, shapes)):
                dimgs[k] = v
        members = [(imgs[k], coords[k], None, None, douts[k], dwmasks[k], dcoords[k],
                    dimgs[k]) for k in range(K) if want_c[k] or want_i[k]]
        _launch.run(_lib().bilinear_group_backward_launch, dev, _pack(members))
        ctx.counter.backward_launches += 1
        return (None, *dimgs, *dcoords)


def launch_group(counter, imgs: Sequence[torch.Tensor],
                 coords: Sequence[torch.Tensor]) -> Tuple[list, list]:
    """(outs, wmasks) of checked CUDA members through the kernels, the launches counted on
    ``counter``."""
    res = _SampleGroup.apply(counter, *imgs, *coords)
    return list(res[:len(imgs)]), list(res[len(imgs):])


def plain_group(imgs: Sequence[torch.Tensor],
                coords: Sequence[torch.Tensor]) -> Tuple[list, list]:
    """(outs, wmasks): ``bilinear_sample_reference`` member by member."""
    pairs = [bilinear_sample_reference(i, c) for i, c in zip(imgs, coords)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def bilinear_sample_group(imgs: Sequence[torch.Tensor],
                          coords: Sequence[torch.Tensor]) -> Tuple[list, list]:
    """(outs, wmasks) of float32 ``imgs[k]`` [B,Hs,Ws,C] sampled at ``coords[k]``
    [B,Ht,Wt,2], each member of its own sizes. On CUDA tensors one launch each way for the
    group (or the call raises); on CPU tensors the plain version member by member."""
    imgs, coords = [i.contiguous() for i in imgs], [c.contiguous() for c in coords]
    check_group(imgs, coords)
    if not imgs[0].is_cuda:
        return plain_group(imgs, coords)
    return launch_group(bilinear_sample, imgs, coords)


def bilinear_sample(imgs: torch.Tensor, coords: torch.Tensor):
    """(out [B,Ht,Wt,C], wmask [B,Ht,Wt,1]) from contiguous float32 ``imgs`` [B,Hs,Ws,C]
    and ``coords`` [B,Ht,Wt,2]: a group of one. On a CUDA tensor this launches the kernel
    or raises."""
    _check(imgs, coords)
    if not imgs.is_cuda:
        return bilinear_sample_reference(imgs, coords)
    outs, wmasks = launch_group(bilinear_sample, [imgs], [coords])
    return outs[0], wmasks[0]


bilinear_sample.launches = 0
bilinear_sample.backward_launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library of ``csrc/bilinear_sample.cu``, typed, with ``tile``: the target pixels
    of a tile."""
    lib = _build.load("bilinear_sample")
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bilinear_group_layout.argtypes, lib.bilinear_group_layout.restype = [ip, ip], None
    for fn in (lib.bilinear_group_forward_launch, lib.bilinear_group_backward_launch):
        fn.argtypes, fn.restype = [ctypes.c_char_p, ctypes.c_void_p], ctypes.c_int
    tile, most = ctypes.c_int(), ctypes.c_int()
    lib.bilinear_group_layout(ctypes.byref(tile), ctypes.byref(most))
    if most.value != MAX_MEMBERS:
        raise RuntimeError(f"csrc/bilinear_sample.cu takes {most.value} members, the wrapper "
                           f"{MAX_MEMBERS}")
    lib.tile = tile.value
    return lib
