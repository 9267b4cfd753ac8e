"""The int8 / bf16 tensor-core probe's gridded product: a CUDA kernel and its plain
version.

``dot_grid(a, b)`` returns ``a . b`` for a [M, K] and b [K, N]: int8 operands give int32,
bf16 operands float32. It replaces ``tools/probe_int8_dot2.py:47 make_pallas_grid`` (the
``pl.pallas_call`` at ``:60``), a 4096^3 product on an (8, 8) grid of 512x512 output tiles
with the full K in each step; ``csrc/dot_grid.cu`` says how the kernel tiles it and what
bounds it.

On a CUDA tensor ``dot_grid`` launches ``csrc/dot_grid.cu`` (counted in
``dot_grid.launches``) or raises; it never hands the product to a library. On a CPU tensor
it runs ``dot_grid_reference``. M, N and K must be multiples of ``TILE``.
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

TILE = (128, 128, 64)  # csrc/dot_grid.cu: the multiples of M, N and K


def dot_grid_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version (``_dot.plain_product``): int8 exactly in float64, then int32;
    bf16 in float32."""
    return plain_product(a, b).to(OUT_DTYPE[a.dtype])


def dot_grid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, N] ``a . b``: int32 from int8, float32 from bf16."""
    check_operands("dot_grid", a, b, TILE)
    if a.device.type == "cpu":
        return dot_grid_reference(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=OUT_DTYPE[a.dtype], device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.dot_grid_launch(*launch_args(a, b, out), int(a.dtype == torch.bfloat16),
                                  stream)
    if err != 0:
        raise RuntimeError(f"dot_grid_launch failed: cudaError_t {err}")
    dot_grid.launches += 1
    return out


dot_grid.launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = bind("dot_grid", [p, p, p, i, i, i, i, p])
    if lib.tile != TILE:
        raise RuntimeError(f"csrc/dot_grid.cu tiles {lib.tile}, ops/dot_grid.py {TILE}")
    return lib
