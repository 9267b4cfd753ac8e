"""The int8 / bf16 tensor-core probe's loop of products: a CUDA kernel and its plain
version.

``dot_loop(a, b, repeats=64)`` returns ``sum over r < repeats of a . b`` for a [M, K] and
b [K, N]: int8 operands give int32, bf16 operands float32. It replaces
``tools/probe_int8_dot.py:43 make_pallas`` (kernel ``_dot_loop_kernel`` at ``:29``), which
issues R = 64 products of 1024^3 from VMEM and adds them, ``acc + dot``; the kernel
issues every product too (``csrc/dot_loop.cu`` says how and what bounds it).

On a CUDA tensor ``dot_loop`` launches ``csrc/dot_loop.cu`` (counted in
``dot_loop.launches``) or raises; it never hands the product to a library. On a CPU
tensor it runs ``dot_loop_reference``. M, N and K must be multiples of ``TILE``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from tf_depth_estimation_torch.ops._dot import (
    OUT_DTYPE,
    bind,
    check_operands,
    launch_args,
    plain_product,
)

TILE = (64, 64, 64)  # csrc/dot_loop.cu: the multiples of M, N and K
REPEATS = 64         # tools/probe_int8_dot.py:27


def dot_loop_reference(a: torch.Tensor, b: torch.Tensor, repeats: int = REPEATS
                       ) -> torch.Tensor:
    """The plain version: the product (``_dot.plain_product``) added ``repeats`` times in
    turn to a zero sum, as ``acc + dot`` in the TPU kernel's loop; int8 exactly in
    float64, then int32, bf16 in float32."""
    p = plain_product(a, b)
    acc = torch.zeros_like(p)
    for _ in range(repeats):
        acc = acc + p
    return acc.to(OUT_DTYPE[a.dtype])


def dot_loop(a: torch.Tensor, b: torch.Tensor, repeats: int = REPEATS) -> torch.Tensor:
    """[M, N] ``sum over r < repeats of a . b``: int32 from int8, float32 from bf16."""
    check_operands("dot_loop", a, b, TILE, repeats)
    if a.device.type == "cpu":
        return dot_loop_reference(a, b, repeats)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=OUT_DTYPE[a.dtype], device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.dot_loop_launch(*launch_args(a, b, out), repeats,
                                  int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dot_loop_launch failed: cudaError_t {err}")
    dot_loop.launches += 1
    return out


dot_loop.launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = bind("dot_loop", [p, p, p, i, i, i, i, i, p])
    if lib.tile != TILE:
        raise RuntimeError(f"csrc/dot_loop.cu tiles {lib.tile}, ops/dot_loop.py {TILE}")
    return lib
