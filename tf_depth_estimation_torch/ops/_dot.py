"""What the two tensor-core probe wrappers (``dot_loop.py``, ``dot_grid.py``) share: the
operand checks, the output type, the plain product and the ctypes binding."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tf_depth_estimation_torch.ops import _build

OUT_DTYPE = {torch.int8: torch.int32, torch.bfloat16: torch.float32}


def check_operands(name: str, a: torch.Tensor, b: torch.Tensor, tile: Tuple[int, int, int],
                   repeats: int = 1) -> None:
    """Raise unless a [M, K] and b [K, N] are contiguous int8 or bf16 matrices of one type
    on one CPU or CUDA device, M, N and K positive multiples of ``tile``, ``repeats`` at
    least 1, and (int8) no sum of the products can pass the int32 range."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes a [M, K] and b [K, N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in OUT_DTYPE:
        raise TypeError(f"{name} takes two int8 or two bfloat16 matrices, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one device, not "
                         f"{a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} takes contiguous (row-major) matrices")
    (M, K), N = a.shape, b.shape[1]
    for dim, size, multiple in (("M", M, tile[0]), ("N", N, tile[1]), ("K", K, tile[2])):
        if size < 1 or size % multiple:
            raise ValueError(f"{name}: {dim} = {size} is not a positive multiple of the "
                             f"kernel's tile, {multiple}")
    if repeats < 1:
        raise ValueError(f"{name}: repeats must be at least 1, got {repeats}")
    if a.dtype == torch.int8 and repeats * K * 128 * 128 >= 2 ** 31:
        raise ValueError(f"{name}: {repeats} x K = {K} products of int8 can pass the "
                         f"int32 range")


def plain_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b exactly for int8 (float64 products and sums: every partial sum is an integer
    below 2^53), and in float32 from the bf16 values upcast for bf16 (TF32 must be off
    on a card: ``torch.backends.cuda.matmul.allow_tf32``)."""
    if a.dtype == torch.int8:
        return a.double() @ b.double()
    return a.float() @ b.float()


def bind(name: str, argtypes: list) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``, type ``<name>_launch`` and return the library with
    ``tile``: the multiples of M, N and K that ``<name>_tile`` reports."""
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes, launch.restype = argtypes, ctypes.c_int
    tile = getattr(lib, f"{name}_tile")
    tile.argtypes, tile.restype = [ctypes.POINTER(ctypes.c_int)] * 3, None
    m, n, k = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    tile(ctypes.byref(m), ctypes.byref(n), ctypes.byref(k))
    lib.tile = (m.value, n.value, k.value)
    return lib


def launch_args(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> tuple:
    return a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1], a.shape[1]
