"""The fused DispNet decoder tail: a CUDA kernel and its plain PyTorch version.

``fused_tail(x2, d2, params)`` computes, from icnv2's output ``x2`` [B,h,w,32] and
``d2`` [B,h,w,1], the full-resolution disparity ``d1`` [B,2h,2w,1] (NHWC, as the JAX
package lays it out):

    up  = relu(su * upcnv1(x2) + tu)                (TF SAME 3x3/s2 deconv, 32 -> 16)
    d2u = TF1 bilinear x2 of d2
    y   = relu(si * icnv1(cat[up, d2u]) + ti)       (3x3, 17 -> 16)
    d1  = disp_scaling * sigmoid(disp1(y) + b) + min_disp   (3x3, 16 -> 1)

It replaces ``tf_depth_estimation_tpu/ops/pallas_tail.py:fused_tail``, whose contract is
``depth_to_space`` of its phase-packed output. With bf16 ``x2`` the upcnv1 and icnv1
weights are rounded to bf16 and the intermediates are rounded at the same two points as in
that kernel: ``up`` and ``d2u`` at the concat, ``y`` before disp1. Products are summed in
float32 and the BN scale multiplies the sum, so it is not folded into the bf16 weights.

On a CUDA tensor ``fused_tail`` launches ``csrc/fused_tail.cu``: with bf16 ``x2`` the
kernel that runs upcnv1 and icnv1 on the tensor cores as GEMMs over the packed operands
``k_up`` and ``k_ic`` (x2 read by TMA, which needs its address 16-byte aligned), with
float32 ``x2`` the CUDA-core kernel. On a CPU tensor it runs ``fused_tail_reference``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from tf_depth_estimation_torch.models.layers import conv2d_same, conv_transpose2d_same
from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.resize import resize_bilinear

# layout of the packed parameter buffer, shared with csrc/fused_tail.cu; k_up and k_ic
# are the bf16 kernel's GEMM operands (_k_up, _k_ic)
_PARTS = (("w_up", (3, 3, 32, 16)), ("w_ic", (3, 3, 17, 16)), ("w_d1", (3, 3, 16)),
          ("su", (16,)), ("tu", (16,)), ("si", (16,)), ("ti", (16,)), ("b_d1", (1,)),
          ("k_up", (64, 128)), ("k_ic", (16, 160)))
N_PARAMS = sum(torch.Size(s).numel() for _, s in _PARTS)


def _k_up(w_up: torch.Tensor) -> torch.Tensor:
    """upcnv1 as one GEMM per x2 cell (U, V), K-major: [64 (p, q, o), 128 (cy, cx, ci)].

    Row (p, q, o) is output channel o of pixel (2U + p, 2V + q); column (cy, cx, ci) is
    channel ci of x2 cell (U - 1 + cy, V - 1 + cx), which reaches that pixel through tap
    (p + 2 - 2 cy, q + 2 - 2 cx) where both are below 3. The transpose of JAX's ``K_up``
    (``pallas_tail.py:prepare_tail_params``). ``w_up``: (a, b, ci, co).
    """
    k = w_up.new_zeros(2, 2, 16, 2, 2, 32)
    for p in range(2):
        for q in range(2):
            for cy in range(2):
                for cx in range(2):
                    a, b = p + 2 - 2 * cy, q + 2 - 2 * cx
                    if a < 3 and b < 3:
                        k[p, q, :, cy, cx, :] = w_up[a, b].t()
    return k.reshape(64, 128)


def _k_ic(w_ic: torch.Tensor) -> torch.Tensor:
    """icnv1 as one GEMM per full-resolution pixel, K-major: [16 o, 160]. Column 16 t + c
    (t = 3a + b < 9, c < 16) is up channel c at tap (a, b); column 144 + t is d2u at tap
    t; the last 7 are zeros. ``w_ic``: (a, b, c, co)."""
    k = w_ic.new_zeros(16, 160)
    k[:, :144] = w_ic[:, :, :16].reshape(144, 16).t()
    k[:, 144:153] = w_ic[:, :, 16].reshape(9, 16).t()
    return k


def prepare_tail_params(w_up1, bn_up1, w_icnv1, bn_icnv1, w_disp1, b_disp1,
                        dtype=torch.float32):
    """Pack the tail's weights for the kernel and its reference.

    ``w_up1`` [32,16,3,3] (``conv_transpose2d`` layout), ``w_icnv1`` [16,17,3,3] and
    ``w_disp1`` [1,16,3,3] (OIHW), ``bn_*`` eval ``(scale, shift)`` pairs, ``b_disp1`` [1].
    ``dtype`` is x2's dtype: for bf16 the upcnv1 and icnv1 weights are rounded to bf16.
    Returns a dict of float32 views into one contiguous buffer, ``"packed"``, and
    ``"disp1_host"``: ``w_d1`` and ``b_d1`` (145 values) in host memory, which the bf16
    kernel takes as launch arguments.
    """
    rnd = lambda t: t.to(dtype).float()
    parts = {
        "w_up": rnd(w_up1).permute(2, 3, 0, 1),          # (a, b, ci, co)
        "w_ic": rnd(w_icnv1).permute(2, 3, 1, 0),        # (a, b, c, co)
        "w_d1": w_disp1.float()[0].permute(1, 2, 0),     # (a, b, c)
        "su": bn_up1[0], "tu": bn_up1[1], "si": bn_icnv1[0], "ti": bn_icnv1[1],
        "b_d1": b_disp1,
    }
    parts["k_up"], parts["k_ic"] = _k_up(parts["w_up"]), _k_ic(parts["w_ic"])
    packed = torch.cat([parts[n].float().reshape(-1) for n, _ in _PARTS])
    out, off = {"packed": packed}, 0
    for n, shape in _PARTS:
        k = torch.Size(shape).numel()
        out[n] = packed[off:off + k].view(shape)
        off += k
    # disp1's weights and bias in host memory, for the bf16 kernel's launch arguments
    out["disp1_host"] = torch.cat([out["w_d1"].reshape(-1), out["b_d1"]]).cpu()
    return out


def fused_tail_reference(x2: torch.Tensor, d2: torch.Tensor, params: dict, *,
                         disp_scaling: float = 4.0, min_disp: float = 0.0) -> torch.Tensor:
    """The plain PyTorch tail, with the kernel's rounding points. Returns [B,2h,2w,1] f32.

    Every conv runs in float32 on the bf16-rounded values, so on the GPU it needs
    ``torch.backends.cudnn.allow_tf32 = False`` to be exact to float32.
    """
    dt = x2.dtype
    rnd = (lambda t: t.to(dt).float()) if dt != torch.float32 else (lambda t: t)
    col = lambda v: v[:, None, None]
    h, w = x2.shape[1:3]
    up = conv_transpose2d_same(x2.permute(0, 3, 1, 2).float(),
                               params["w_up"].permute(2, 3, 0, 1))
    up = torch.relu(up * col(params["su"]) + col(params["tu"]))
    d2u = resize_bilinear(d2.permute(0, 3, 1, 2).float(), (2 * h, 2 * w))
    cat = torch.cat([rnd(up), rnd(d2u)], 1)
    y = conv2d_same(cat, params["w_ic"].permute(3, 2, 0, 1))
    y = rnd(torch.relu(y * col(params["si"]) + col(params["ti"])))
    d1 = conv2d_same(y, params["w_d1"].permute(2, 0, 1)[None], params["b_d1"])
    return (disp_scaling * torch.sigmoid(d1) + min_disp).permute(0, 2, 3, 1)


def _check(x2: torch.Tensor, d2: torch.Tensor, packed: torch.Tensor) -> None:
    if x2.dim() != 4 or x2.shape[-1] != 32:
        raise ValueError(f"x2 must be [B,h,w,32], got {tuple(x2.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x2 must be float32 or bfloat16, got {x2.dtype}")
    if tuple(d2.shape) != (*x2.shape[:3], 1) or d2.dtype != torch.float32:
        raise ValueError(f"d2 must be float32 [B,h,w,1] matching x2, got "
                         f"{d2.dtype} {tuple(d2.shape)}")
    if packed.dtype != torch.float32 or packed.numel() != N_PARAMS:
        raise ValueError(f"params['packed'] must hold {N_PARAMS} float32 values")
    for name, t in (("x2", x2), ("d2", d2), ("params['packed']", packed)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x2 on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_tail(x2: torch.Tensor, d2: torch.Tensor, params: dict, *,
               disp_scaling: float = 4.0, min_disp: float = 0.0) -> torch.Tensor:
    """d1 [B,2h,2w,1] float32 from x2 [B,h,w,32] (f32/bf16) and d2 [B,h,w,1] f32.

    ``params`` comes from ``prepare_tail_params`` with x2's dtype, whole: the bf16 kernel
    reads disp1's weights from ``params["disp1_host"]``, the host copy of the packed
    ``w_d1`` and ``b_d1`` made by the same call. On a CUDA tensor this launches the kernel
    (and counts the launch in ``fused_tail.launches``) or raises.
    """
    packed = params["packed"]
    _check(x2, d2, packed)
    if x2.device.type == "cpu":
        return fused_tail_reference(x2, d2, params, disp_scaling=disp_scaling,
                                    min_disp=min_disp)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_tail runs on CUDA or CPU tensors, not {x2.device}")
    if x2.dtype == torch.bfloat16 and x2.data_ptr() % 16:
        raise ValueError("bf16 x2 must start at a 16-byte aligned address (the kernel reads "
                         "it by TMA)")
    head = params.get("disp1_host")  # read by the bf16 launch only
    if x2.dtype == torch.bfloat16 and (
            head is None or head.device.type != "cpu" or head.dtype != torch.float32
            or head.numel() != 9 * 16 + 1 or not head.is_contiguous()):
        raise ValueError("params['disp1_host'] must hold w_d1 and b_d1, 145 float32 values "
                         "in host memory (prepare_tail_params)")
    B, h, w, _ = x2.shape
    out = torch.empty((B, 2 * h, 2 * w, 1), dtype=torch.float32, device=x2.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    host = head.data_ptr() if x2.dtype == torch.bfloat16 else None
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.fused_tail_launch(
            x2.data_ptr(), d2.data_ptr(), packed.data_ptr(), host, out.data_ptr(),
            B, h, w, int(x2.dtype == torch.bfloat16), float(disp_scaling), float(min_disp),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_tail_launch failed: error {err} (a cudaError_t; -1: the "
                           "driver gives no cuTensorMapEncodeTiled; -1000 - CUresult: x2's "
                           "tensor map refused)")
    fused_tail.launches += 1
    return out


fused_tail.launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_tail")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_tail_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, f, p]
    lib.fused_tail_launch.restype = i
    lib.fused_tail_num_params.argtypes = []
    lib.fused_tail_num_params.restype = i
    if lib.fused_tail_num_params() != N_PARAMS:
        raise RuntimeError("csrc/fused_tail.cu and ops/fused_tail.py disagree on the "
                           "parameter layout")
    return lib
