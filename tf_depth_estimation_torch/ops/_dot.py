"""What the two tensor-core probe wrappers (``dot_loop.py``, ``dot_grid.py``) share: the
operand checks, the output type, the plain product, the ctypes binding and the launch."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
    if a.device.type == "cuda" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"{name} takes matrices that start on 16 bytes (TMA's alignment)")
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


def launch(fn, c_launch, a: torch.Tensor, b: torch.Tensor, *ints: int,
           parts: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel ``c_launch`` (``<name>_launch``) on a and b on their card, with
    ``ints`` after M, N and K, and count it on the wrapper ``fn``: ``fn.launches`` the
    products, ``fn.transposes`` the transposes of B that go before them, and, where
    ``parts`` (a loop's K parts) is given, ``fn.reduces`` the sums of two or more parts
    that go after them. Raises when a launch fails."""
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=OUT_DTYPE[a.dtype], device=a.device)
    # wgmma reads int8 B only K-major, so an int8 call transposes B into ``bt`` first;
    # bf16 reads B as it is, N-major (csrc/dot_tile.cuh)
    kmajor = a.dtype == torch.int8
    bt = torch.empty((N, K), dtype=a.dtype, device=a.device) if kmajor else None
    scratch = []
    if parts is not None:  # the planes of the K parts' sums, for two or more
        planes = torch.empty((parts, M, N), dtype=out.dtype, device=a.device) if parts > 1 \
            else None
        scratch = [None if planes is None else planes.data_ptr()]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = c_launch(a.data_ptr(), b.data_ptr(), None if bt is None else bt.data_ptr(),
                       *scratch, out.data_ptr(), M, N, K, *ints,
                       int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{c_launch.__name__} failed: {err} (a cudaError_t, or "
                           f"negative: csrc/dot_tile.cuh:launch_typed)")
    fn.launches += 1
    fn.transposes += int(kmajor)
    if parts is not None:
        fn.reduces += int(parts > 1)
    return out
