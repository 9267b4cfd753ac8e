"""Probe: do the card's int8 tensor cores run at twice the bf16 rate through a loop of
products written by hand?

The counterpart of ``tools/probe_int8_dot.py`` for the H100. The same operands (A and B
[1024, 1024], ``RandomState(0)``), the same R = 64 accumulated products a call (137.4 G
operations), the same cases, timing method (best of 5 windows of 8 calls, host clock,
each window ended by reading the f32 sum back) and printed lines:
  * ``kernel_*``: ``csrc/dot_loop.cu`` through ``ops/dot_loop.py`` (the JAX probe's
    ``pallas_*``), then ``jnp.sum``'s counterpart, ``.float().sum()``;
  * ``torch_*``: the library yardstick, R library products added in turn
    (``tools/common.py:library_product``; the JAX probe's ``xla_*``).
On the H100 the data sheet gives int8 1,979 TOPS against bf16 989 TFLOP/s; the last lines
print the measured int8 / bf16 ratio of the kernel and of the library. A kernel that fails
to build or launch raises, and the run exits non-zero. There is no CPU path.

Usage: python -m tf_depth_estimation_torch.tools.probe_int8_dot
"""
from __future__ import annotations

from typing import Dict

import torch

from tf_depth_estimation_torch.ops.dot_loop import dot_loop
from tf_depth_estimation_torch.tools.common import (
    inputs,
    library_product,
    require_cuda,
    time_2arg,
)

M = K = N = 1024
R = 64  # products per call; operations = R * 2 * M*K*N = 137.4 G


def make_kernel():
    return lambda a, b: dot_loop(a, b, R).float().sum()


def library_loop(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """R library products of a . b added in turn: the yardstick of ``dot_loop``."""
    mm = library_product(a.dtype)[0]
    acc = mm(a, b)
    for _ in range(R - 1):
        acc = acc + mm(a, b)
    return acc


def make_torch():
    return lambda a, b: library_loop(a, b).float().sum()


def main() -> Dict[str, float]:
    print(f"device: {require_cuda()}")
    x = inputs(M, K, N)
    print(f"library bf16 product: {library_product(torch.bfloat16)[1]}")
    gflop = R * 2.0 * M * K * N / 1e9
    results = {}
    cases = [
        ("kernel_bf16", make_kernel, x["abf"], x["bbf"]),
        ("kernel_int8", make_kernel, x["a8"], x["b8"]),
        ("torch_bf16", make_torch, x["abf"], x["bbf"]),
        ("torch_int8", make_torch, x["a8"], x["b8"]),
    ]
    for name, maker, a, b in cases:
        dt = time_2arg(maker(), a, b)
        results[name] = dt
        print(f"{name:12s}: {dt*1e3:8.3f} ms  {gflop / dt / 1e3:8.1f} TFLOP(int-OP)/s")

    r = results["kernel_bf16"] / results["kernel_int8"]
    print(f"\nkernel int8 speedup vs bf16: {r:.2f}x "
          f"({'DOUBLE-RATE PATH REACHED' if r >= 1.5 else 'no double-rate'})")
    r = results["torch_bf16"] / results["torch_int8"]
    print(f"torch  int8 speedup vs bf16: {r:.2f}x")
    return results


if __name__ == "__main__":
    main()
