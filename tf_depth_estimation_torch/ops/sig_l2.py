"""Scale-invariant-gradient L2 loss: a CUDA forward and backward for a group of maps, and
the plain version.

``sig_l2_fused_group(preds, gts, deltas, coefs, eps_sig=1e-3, eps_l2=1e-6)`` takes float32
pairs [B, H, W, C] (of any sizes, each gt the shape of its pred), one set of deltas and a
Python float a pair, and returns ``(total, per_map)``: ``per_map[k]`` is
``pointwise_l2_loss(sig(preds[k], deltas), sig(gts[k], deltas), eps_l2)`` (the plain
version, ``ops/sig.py:sig_l2_plain``: for each delta and axis the normalised forward
difference (f(i+d) - f(i)) / (|f(i+d)| + |f(i)| + eps_sig) of each map, zero where i+d
leaves the image; per pixel sqrt(sum of the squared differences + eps_l2); the mean over
pixels), and ``total`` is ``sum_k coefs[k] * per_map[k]``, summed in the order of the
pairs. ``sig_l2_fused(pred, gt, deltas=(2,), eps_sig=1e-3, eps_l2=1e-6)`` is the scalar
term of one pair, a group of one. They replace
``tf_depth_estimation_tpu/ops/pallas_losses.py:116 sig_l2_fused`` (kernel ``_sig_kernel``
at ``:63``) and keep its eligibility rule (``_sig_fused_impl``, ``:81-86``) pair by pair:
where C != 1 the pair's term is the plain composition.

On CUDA tensors the eligible pairs of a group go to ``csrc/sig_l2.cu`` in one forward and
one backward launch, at most ``MAX_MAPS`` of them; the backward also writes the gradients
of the gts when one of them needs a gradient. ``sig_l2_fused.launches`` and
``.backward_launches`` count those launches, one per group call each way (a call of
``sig_l2_fused`` is a group call), or the call raises. The coefficients and deltas go to
the kernel as arguments. The maps are read in place through their strides, so a C = 1
head of an NCHW tensor viewed NHWC needs no copy. Where a group mixes eligible and other
pairs, ``total`` adds the kernel's sum of its pairs first and the plain terms after it, in
their order. On CPU tensors the group is ``sig_l2_plain_group``, the plain composition
pair by pair under autograd. Only float32 is taken.

``sig_l2_backward_reference`` is the backward kernel's formula in plain PyTorch, in
gather form and in the kernel's order of operations; the tests hold it against autograd
of the plain version.

The derivative of |f| in a denominator is taken as sgn(f) with sgn(0) = 0, as PyTorch's
``abs`` backward takes it (JAX's is +1 at 0). The training path feeds inverse depths and
depths, which are positive, so f = 0 does not arise there.
"""
from __future__ import annotations

import ctypes
import struct
from functools import lru_cache
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tf_depth_estimation_torch.ops import _build, _launch
from tf_depth_estimation_torch.ops.sig import sig_l2_plain

MAX_DELTAS = 8  # csrc/sig_l2.cu MAX_DELTAS
MAX_MAPS = 8    # csrc/sig_l2.cu MAX_MAPS
# csrc/sig_l2.cu Group (n_maps, n_tiles, nd, eps_sig, eps_l2, pad, d[MAX_DELTAS]) and
# MapDesc (pred's plane, gt's plane, out_off, B, H, W, first_tile, bands, strips, coef,
# vec), 56 and 104 bytes
_HEAD = struct.Struct(f"=iiiffi{MAX_DELTAS}i")
_MAP = struct.Struct("=QqqqQqqqqiiiiiifi")


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




def _check(pred: torch.Tensor, gt: torch.Tensor) -> None:
    if pred.dim() != 4 or pred.shape != gt.shape:
        raise ValueError(f"sig_l2_fused takes pred and gt [B,H,W,C] of one shape, got "
                         f"{tuple(pred.shape)} and {tuple(gt.shape)}")
    if pred.dtype != torch.float32 or gt.dtype != torch.float32:
        raise TypeError(f"sig_l2_fused takes float32, got {pred.dtype} and {gt.dtype}")
    if pred.device != gt.device or pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sig_l2_fused runs on CUDA or CPU tensors on one device, not "
                         f"{pred.device} and {gt.device}")


def _check_group(preds: List[torch.Tensor], gts: List[torch.Tensor], deltas: Tuple[int, ...],
                 coefs: List[float]) -> None:
    if not 1 <= len(preds) <= MAX_MAPS or len(gts) != len(preds) or len(coefs) != len(preds):
        raise ValueError(f"sig_l2_fused_group takes 1 to {MAX_MAPS} pairs and a coefficient "
                         f"each, got {len(preds)} preds, {len(gts)} gts and {len(coefs)} "
                         f"coefficients")
    if not 1 <= len(deltas) <= MAX_DELTAS or min(deltas) < 1:
        raise ValueError(f"sig_l2_fused takes 1 to {MAX_DELTAS} deltas of at least 1, got "
                         f"{deltas}")
    for p, g in zip(preds, gts):
        _check(p, g)
        if p.device != preds[0].device:
            raise ValueError(f"sig_l2_fused_group takes pairs on one device, got "
                             f"{preds[0].device} and {p.device}")


def _plane(x: torch.Tensor):
    """(pointer, batch, row and column strides, 16-byte loads allowed) of a [B, H, W, 1]
    map."""
    sb, sh, sw, _ = x.stride()
    ptr = x.data_ptr()
    return ptr, sb, sh, sw, sw == 1 and ptr % 16 == 0 and sh % 4 == 0 and sb % 4 == 0


def _plan(preds, gts, deltas, coefs, eps_sig, eps_l2):
    """(the packed group for ``csrc/sig_l2.cu``, its tiles, each pair's gradient as
    (shape, strides, offset) in the flat s and gradient buffers, their length). Each pair's
    pixels start on 16 bytes."""
    th, tw = _lib().tile
    parts, layout, tiles, off = [], [], 0, 0
    for p, g, c in zip(preds, gts, coefs):
        shape = p.shape
        B, H, W, _ = shape
        *pp, pvec = _plane(p)
        *gp, gvec = _plane(g)
        bands, strips = -(-H // th), -(-W // tw)
        parts.append(_MAP.pack(*pp, *gp, off, B, H, W, tiles, bands, strips, c,
                               int(pvec) | 2 * int(gvec)))
        layout.append((shape, (H * W, W, 1, 1), off))
        tiles += B * bands * strips
        off += -(-(B * H * W) // 4) * 4
    head = _HEAD.pack(len(preds), tiles, len(deltas), eps_sig, eps_l2, 0,
                      *deltas, *(0,) * (MAX_DELTAS - len(deltas)))
    return head + b"".join(parts), tiles, layout, off


class _SigL2Group(torch.autograd.Function):
    """(total, per_map) of eligible CUDA pairs: one launch each way."""

    @staticmethod
    def forward(ctx, deltas, coefs, eps_sig, eps_l2, *pairs):
        ctx.set_materialize_grads(False)
        K = len(pairs) // 2
        preds, gts = pairs[:K], pairs[K:]
        desc, tiles, layout, pixels = _plan(preds, gts, deltas, coefs, eps_sig, eps_l2)
        # one allocation: the total and the K terms, s from a 16-byte boundary, the slots
        s_at = -(-(1 + K) // 4) * 4
        buf = torch.empty((s_at + pixels + tiles,), dtype=torch.float32, device=preds[0].device)
        ptr = buf.data_ptr()
        _launch.run(_lib().sig_l2_group_forward, buf.device, desc, ptr + 4 * s_at,
                    ptr + 4 * (s_at + pixels), ptr, ticket=True)
        sig_l2_fused.launches += 1
        ctx.save_for_backward(*pairs, buf)
        ctx.desc, ctx.layout, ctx.pixels, ctx.s_at = desc, layout, pixels, s_at
        return buf[0], buf[1:1 + K]

    @staticmethod
    @once_differentiable
    def backward(ctx, ct, ct_maps):
        *pairs, buf = ctx.saved_tensors
        K = len(pairs) // 2
        need = ctx.needs_input_grad[4:]
        need_gt = any(need[K:])
        # d pred of every pair, then (when a gt needs one) d gt of every pair
        grad = torch.empty(((2 if need_gt else 1) * ctx.pixels,), dtype=torch.float32,
                           device=buf.device)
        ptr = grad.data_ptr()
        _launch.run(_lib().sig_l2_group_backward, buf.device, ctx.desc,
                    buf.data_ptr() + 4 * ctx.s_at, None if ct is None else ct.data_ptr(),
                    None if ct_maps is None else ct_maps.data_ptr(),
                    0 if ct_maps is None else ct_maps.stride(0), ptr,
                    ptr + 4 * ctx.pixels if need_gt else None)
        sig_l2_fused.backward_launches += 1
        views = [torch.as_strided(grad, shape, strides, h * ctx.pixels + off) if n else None
                 for h in range(2)
                 for (shape, strides, off), n in zip(ctx.layout, need[h * K:(h + 1) * K])]
        return (None, None, None, None, *views)


def sig_l2_plain_group(preds: Sequence[torch.Tensor], gts: Sequence[torch.Tensor],
                       deltas: Sequence[int], coefs: Sequence[float], eps_sig: float = 0.001,
                       eps_l2: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``sig_l2_fused_group``: the plain composition pair by pair
    under autograd; ``total`` summed in the order of the pairs."""
    return _launch.group_terms(
        coefs, [False] * len(preds), None,
        lambda k: sig_l2_plain(preds[k], gts[k], deltas, eps_sig, eps_l2))


def sig_l2_fused_group(preds: Sequence[torch.Tensor], gts: Sequence[torch.Tensor],
                       deltas: Sequence[int], coefs: Sequence[float], eps_sig: float = 0.001,
                       eps_l2: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_k coefs[k] * term_k, [term_k]) of float32 pairs [B, H, W, C], term_k the sig L2
    loss of ``(preds[k], gts[k])`` over ``deltas``. The eligible CUDA pairs go through one
    launch each way (or the call raises); the others, and CPU pairs, through the plain
    composition."""
    preds, gts = list(preds), list(gts)
    deltas, coefs = tuple(int(d) for d in deltas), [float(c) for c in coefs]
    eps_sig, eps_l2 = float(eps_sig), float(eps_l2)
    _check_group(preds, gts, deltas, coefs)
    if not preds[0].is_cuda:
        return sig_l2_plain_group(preds, gts, deltas, coefs, eps_sig, eps_l2)
    eligible = [p.shape[-1] == 1 for p in preds]
    if all(eligible):
        return _SigL2Group.apply(deltas, coefs, eps_sig, eps_l2, *preds, *gts)
    return _launch.group_terms(
        coefs, eligible,
        lambda ks: _SigL2Group.apply(deltas, [coefs[k] for k in ks], eps_sig, eps_l2,
                                     *(preds[k] for k in ks), *(gts[k] for k in ks)),
        lambda k: sig_l2_plain(preds[k], gts[k], deltas, eps_sig, eps_l2))


def sig_l2_fused(pred: torch.Tensor, gt: torch.Tensor, deltas: Sequence[int] = (2,),
                 eps_sig: float = 0.001, eps_l2: float = 1e-6) -> torch.Tensor:
    """mean over pixels of sqrt(sum over deltas and axes (sig(pred) - sig(gt))^2 + eps_l2)
    for float32 ``pred`` and ``gt`` [B, H, W, C]. On C = 1 CUDA tensors a group of one on
    the kernels (or the call raises); elsewhere the plain composition."""
    deltas = tuple(int(d) for d in deltas)
    _check_group([pred], [gt], deltas, [1.0])
    if pred.is_cuda and pred.shape[-1] == 1:
        return _SigL2Group.apply(deltas, [1.0], float(eps_sig), float(eps_l2), pred, gt)[0]
    return sig_l2_plain(pred, gt, deltas, eps_sig, eps_l2)


sig_l2_fused.launches = 0
sig_l2_fused.backward_launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library of ``csrc/sig_l2.cu``, typed, with ``tile``: its (rows, columns)."""
    lib = _build.load("sig_l2")
    p, ll, ip = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    lib.sig_l2_layout.argtypes, lib.sig_l2_layout.restype = [ip, ip, ip, ip], None
    lib.sig_l2_group_forward.argtypes = [ctypes.c_char_p, p, p, p, p, p]
    lib.sig_l2_group_forward.restype = ctypes.c_int
    lib.sig_l2_group_backward.argtypes = [ctypes.c_char_p, p, p, p, ll, p, p, p]
    lib.sig_l2_group_backward.restype = ctypes.c_int
    th, tw, most, nd = (ctypes.c_int() for _ in range(4))
    lib.sig_l2_layout(*(ctypes.byref(v) for v in (th, tw, most, nd)))
    if (most.value, nd.value) != (MAX_MAPS, MAX_DELTAS):
        raise RuntimeError(f"csrc/sig_l2.cu takes {most.value} pairs and {nd.value} "
                           f"deltas, the wrapper {MAX_MAPS} and {MAX_DELTAS}")
    lib.tile = (th.value, tw.value)
    return lib
