"""Second-order smoothness: a CUDA forward and backward for a group of maps, and the plain
version.

``smoothness_fused_group(maps, coefs)`` takes float32 maps [B, H, W, C] (of any sizes) and
Python floats and returns ``(total, per_map)``: ``per_map[k]`` is
``second_order_smoothness(maps[k])`` (the plain version, in ``losses/basic.py``: mean |dxx|
+ mean |dyy| + mean |dxdy| + mean |dydx|, each mean over its own valid count, the sum
averaged over the batch), and ``total`` is ``sum_k coefs[k] * per_map[k]``, summed in the
order of the maps. ``smoothness_fused(pred)`` is the scalar term of one map, a group of one.
They replace ``tf_depth_estimation_tpu/ops/pallas_losses.py:182 smoothness_fused`` (kernel
``_smooth_kernel`` at ``:140``) and keep its eligibility rule (``_smooth_fused_impl``,
``:162-165``) map by map: where C != 1, H < 3 or W < 3 the map's term is the plain one.

On CUDA tensors the eligible maps of a group go to ``csrc/smoothness.cu`` in one forward
and one backward launch, at most ``MAX_MAPS`` of them; ``smoothness_fused.launches`` and
``.backward_launches`` count those launches, one per group call each way (a call of
``smoothness_fused`` is a group call), or the call raises. The coefficients go to the
kernel as arguments. The maps are read in place through their strides, so a C=1 channel
of an NCHW head viewed NHWC needs no copy. Where a group mixes eligible and other maps,
``total`` adds the kernel's sum of its maps first and the plain terms after it, in their
order. On CPU tensors the group is ``smoothness_plain_group``, the plain term map by map
under autograd. Only float32 is accepted.

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
import struct
from functools import lru_cache
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tf_depth_estimation_torch.losses.basic import second_order_smoothness
from tf_depth_estimation_torch.ops import _build, _launch

MAX_MAPS = 16  # csrc/smoothness.cu MAX_MAPS
_HEAD = struct.Struct("=ii")             # csrc/smoothness.cu Group: n_maps, n_tiles
_MAP = struct.Struct("=Qqqqqiiiiiifi")  # csrc/smoothness.cu MapDesc, 72 bytes


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


def _check_group(maps: List[torch.Tensor], coefs: List[float]) -> None:
    if not 1 <= len(maps) <= MAX_MAPS or len(coefs) != len(maps):
        raise ValueError(f"smoothness_fused_group takes 1 to {MAX_MAPS} maps and a "
                         f"coefficient each, got {len(maps)} maps and {len(coefs)} "
                         f"coefficients")
    for m in maps:
        _check(m)
        if m.device != maps[0].device:
            raise ValueError(f"smoothness_fused_group takes maps on one device, got "
                             f"{maps[0].device} and {m.device}")


def _plan(maps: Sequence[torch.Tensor], coefs: Sequence[float]):
    """(the packed group for ``csrc/smoothness.cu``, its tiles, each map's gradient as
    (shape, strides, offset) in the flat gradient, the gradient's length). Each map's
    pixels start on 16 bytes."""
    th, tw = _lib().tile
    parts, layout, tiles, off = [], [], 0, 0
    for m, c in zip(maps, coefs):
        shape = m.shape
        B, H, W, _ = shape
        sb, sh, sw, _ = m.stride()
        ptr = m.data_ptr()
        bands, strips = -(-H // th), -(-W // tw)
        vec = int(sw == 1 and ptr % 16 == 0 and sh % 4 == 0 and sb % 4 == 0)
        parts.append(_MAP.pack(ptr, sb, sh, sw, off, B, H, W, tiles, bands, strips, c, vec))
        layout.append((shape, (H * W, W, 1, 1), off))
        tiles += B * bands * strips
        off += -(-(B * H * W) // 4) * 4
    return _HEAD.pack(len(maps), tiles) + b"".join(parts), tiles, layout, off


class _SmoothnessGroup(torch.autograd.Function):
    """(total, per_map) of eligible CUDA maps: one launch each way."""

    @staticmethod
    def forward(ctx, coefs, *maps):
        ctx.set_materialize_grads(False)
        desc, tiles, layout, pixels = _plan(maps, coefs)
        K = len(maps)
        # one allocation: the total, the K terms, then 4 slots a tile
        buf = torch.empty((1 + K + 4 * tiles,), dtype=torch.float32, device=maps[0].device)
        ptr = buf.data_ptr()
        _launch.run(_lib().smoothness_group_forward, buf.device, desc, ptr + 4 * (1 + K), ptr,
                    ticket=True)
        smoothness_fused.launches += 1
        ctx.save_for_backward(*maps)
        ctx.desc, ctx.layout, ctx.pixels = desc, layout, pixels
        return buf[0], buf[1:1 + K]

    @staticmethod
    @once_differentiable
    def backward(ctx, ct, ct_maps):
        maps = ctx.saved_tensors
        grad = torch.empty((ctx.pixels,), dtype=torch.float32, device=maps[0].device)
        _launch.run(_lib().smoothness_group_backward, grad.device, ctx.desc,
                    None if ct is None else ct.data_ptr(),
                    None if ct_maps is None else ct_maps.data_ptr(),
                    0 if ct_maps is None else ct_maps.stride(0), grad.data_ptr())
        smoothness_fused.backward_launches += 1
        return (None, *(torch.as_strided(grad, *at) if need else None
                        for at, need in zip(ctx.layout, ctx.needs_input_grad[1:])))


def smoothness_plain_group(maps: Sequence[torch.Tensor],
                           coefs: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``smoothness_fused_group``: the plain term map by map under
    autograd; ``total`` summed in the order of the maps."""
    return _launch.group_terms(coefs, [False] * len(maps), None,
                               lambda k: second_order_smoothness(maps[k]))


def smoothness_fused_group(maps: Sequence[torch.Tensor],
                           coefs: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_k coefs[k] * term_k, [term_k]) of float32 maps [B, H, W, C], term_k the second-
    order smoothness of ``maps[k]``. The eligible CUDA maps go through one launch each way
    (or the call raises); the others, and CPU maps, through the plain term."""
    maps, coefs = list(maps), [float(c) for c in coefs]
    _check_group(maps, coefs)
    if not maps[0].is_cuda:
        return smoothness_plain_group(maps, coefs)
    eligible = [_eligible(m) for m in maps]
    if all(eligible):
        return _SmoothnessGroup.apply(coefs, *maps)
    return _launch.group_terms(
        coefs, eligible,
        lambda ks: _SmoothnessGroup.apply([coefs[k] for k in ks], *(maps[k] for k in ks)),
        lambda k: second_order_smoothness(maps[k]))


def smoothness_fused(pred: torch.Tensor) -> torch.Tensor:
    """The scalar second-order smoothness of float32 ``pred`` [B, H, W, C]. On an eligible
    CUDA tensor a group of one on the kernels (or the call raises); elsewhere the plain
    term."""
    _check(pred)
    if pred.is_cuda and _eligible(pred):
        return _SmoothnessGroup.apply([1.0], pred)[0]
    return second_order_smoothness(pred)


smoothness_fused.launches = 0
smoothness_fused.backward_launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library of ``csrc/smoothness.cu``, typed, with ``tile``: its (rows, columns)."""
    lib = _build.load("smoothness")
    p, ll, ip = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    lib.smoothness_layout.argtypes, lib.smoothness_layout.restype = [ip, ip, ip], None
    lib.smoothness_group_forward.argtypes = [ctypes.c_char_p, p, p, p, p]
    lib.smoothness_group_forward.restype = ctypes.c_int
    lib.smoothness_group_backward.argtypes = [ctypes.c_char_p, p, p, ll, p, p]
    lib.smoothness_group_backward.restype = ctypes.c_int
    th, tw, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.smoothness_layout(ctypes.byref(th), ctypes.byref(tw), ctypes.byref(most))
    if most.value != MAX_MAPS:
        raise RuntimeError(f"csrc/smoothness.cu takes {most.value} maps, the wrapper "
                           f"{MAX_MAPS}")
    lib.tile = (th.value, tw.value)
    return lib
