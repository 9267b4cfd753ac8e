"""Probe 2: int8 against bf16 tensor-core rate at a shape that fills the card.

The counterpart of ``tools/probe_int8_dot2.py`` for the H100: one 4096^3 product (137.4 G
operations), the same operands (``RandomState(0)``), cases, timing method (best of 5
windows of 8 calls, host clock, each window ended by reading the f32 sum back) and
printed lines:
  * ``torch_single_*``: one library product (``tools/common.py:library_product``; the
    JAX probe's ``xla_single_*``);
  * ``kernel_grid_*``: ``csrc/dot_grid.cu`` through ``ops/dot_grid.py`` (the JAX probe's
    ``pallas_grid_*``, a 512x512-tiled grid on the TPU).
The last lines print each family's int8 / bf16 ratio. A kernel that fails to build or
launch raises, and the run exits non-zero. There is no CPU path.

Usage: python -m tf_depth_estimation_torch.tools.probe_int8_dot2
"""
from __future__ import annotations

from typing import Dict

import torch

from tf_depth_estimation_torch.ops.dot_grid import dot_grid
from tf_depth_estimation_torch.tools.common import (
    inputs,
    library_product,
    require_cuda,
    time_2arg,
)

M = K = N = 4096


def make_torch_single(dtype: torch.dtype):
    mm = library_product(dtype)[0]
    return lambda a, b: mm(a, b).float().sum()


def make_kernel_grid():
    return lambda a, b: dot_grid(a, b).float().sum()


def main() -> Dict[str, float]:
    print(f"device: {require_cuda()}")
    x = inputs(M, K, N)
    print(f"library bf16 product: {library_product(torch.bfloat16)[1]}")
    gflop = 2.0 * M * K * N / 1e9
    results = {}
    cases = [
        ("torch_single_bf16", make_torch_single(torch.bfloat16), x["abf"], x["bbf"]),
        ("torch_single_int8", make_torch_single(torch.int8), x["a8"], x["b8"]),
        ("kernel_grid_bf16", make_kernel_grid(), x["abf"], x["bbf"]),
        ("kernel_grid_int8", make_kernel_grid(), x["a8"], x["b8"]),
    ]
    for name, f, a, b in cases:
        dt = time_2arg(f, a, b)
        results[name] = dt
        print(f"{name:17s}: {dt*1e3:8.3f} ms  {gflop/dt/1e3:8.1f} T(FL)OP/s")

    for fam in ("torch_single", "kernel_grid"):
        r = results[f"{fam}_bf16"] / results[f"{fam}_int8"]
        print(f"{fam}: int8 speedup vs bf16 = {r:.2f}x"
              + ("  <-- DOUBLE-RATE PATH" if r >= 1.5 else ""))
    return results


if __name__ == "__main__":
    main()
