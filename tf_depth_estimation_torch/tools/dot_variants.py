"""Timings of variants of the probe kernels, to show what holds them back on the card.

Each variant is a copy of the headers of ``csrc/`` and of ``csrc/dot_grid.cu`` or
``csrc/dot_loop.cu`` with a few lines of ``csrc/dot_tile.cuh`` or the kernel's source
changed, built with the port's flags beside the
committed kernels. All run at the probes' shapes (one 4096^3 product, 64 products of
1024^3), int8 and bf16, in turns (committed, variants, variants reversed, committed),
the best of 5 CUDA-event windows of 10 calls each:
  * ``no stores``: the tile is computed and nothing is written, so the time left is the
    products alone (the output is wrong);
  * ``stores from registers``: dot_grid writes its tile straight from the registers, as
    the first version did, instead of staging it for TMA stores;
  * ``3 stages``: a ring of 3 stages instead of 4;
  * ``128x128 tiles``: dot_grid on the loop's tile width;
  * ``bf16 reads B^T``: bf16 transposes B first and reads it K-major, as int8 must,
    instead of reading it N-major through the descriptor's transpose bit;
  * ``one sum``: dot_loop accumulates all R products in one set of registers, without
    the wait and the adds after each product (another rounding: a timing only).
A variant's output is not checked; ``chip_smoke.py`` checks the committed kernels.

Usage: python -m tf_depth_estimation_torch.tools.dot_variants
"""
from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import torch

from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.tools.common import (
    best_ms,
    build_variant,
    inputs,
    require_cuda,
)

HEADER = "dot_tile.cuh"
READ_BT = (HEADER, "constexpr bool b_kmajor() { return sizeof(T) == 1; }",
           "constexpr bool b_kmajor() { return true; }")  # bf16 reads B^T too
# (kernel, variant) -> [(file, old text, new text)]
VARIANTS: Dict[Tuple[str, str], List[Tuple[str, str, str]]] = {
    ("dot_grid", "no stores"): [(HEADER, "      tma_store_tile<BN>(acc,",
                                 "      if (acc[0] == AccT(123457)) tma_store_tile<BN>(acc,")],
    ("dot_grid", "stores from registers"): [(
        HEADER, "      tma_store_tile<BN>(acc, &mapC, smem + off, sbase + off, wg, "
                "tm * BM + wg * 64, tn * BN);",
        "      store_tile<BN>(acc, static_cast<AccT*>(p.out), tm * BM + wg * 64 + warp * 16 "
        "+ lane / 4, tn * BN + (lane % 4) * 2, p.M, p.N);")],
    ("dot_grid", "3 stages"): [(HEADER, "constexpr int STAGES = 4;",
                                "constexpr int STAGES = 3;")],
    ("dot_grid", "128x128 tiles"): [("dot_grid.cu", "constexpr int BN = 256;",
                                     "constexpr int BN = 128;")],
    ("dot_grid", "bf16 reads B^T"): [READ_BT],
    ("dot_loop", "bf16 reads B^T"): [READ_BT],
    ("dot_loop", "no stores"): [(HEADER, "      store_tile<BN>(sum, out,",
                                 "      if (sum[0] == AccT(123457)) store_tile<BN>(sum, out,")],
    ("dot_loop", "one sum"): [
        (HEADER, "mma<T, BN, B_KMAJOR ? 0 : 1>(acc, da, db, (i > 0 || k > 0) ? 1 : 0);",
         "mma<T, BN, B_KMAJOR ? 0 : 1>(acc, da, db, (r > 0 || i > 0 || k > 0) ? 1 : 0);"),
        (HEADER, "      wgmma_wait<0>();\n      if (kend > kbeg) {",
         "      if (r + 1 == reps) wgmma_wait<0>();\n      if (kend > kbeg && r + 1 == reps) {")],
}
SHAPES = {"dot_grid": (4096, 4096, 4096, 1), "dot_loop": (1024, 1024, 1024, 64)}
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "dot_variants")


def build(kernel: str, variant: str):
    """The variant's library (``<kernel>_launch`` typed), built from patched copies."""
    d = os.path.join(OUT, kernel, variant.replace(" ", "_"))
    lib = build_variant(kernel, VARIANTS.get((kernel, variant), []), d)
    fn = getattr(ctypes.CDLL(lib), f"{kernel}_launch")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * 4 + [i] * 4 + [p] if kernel == "dot_grid"
                   else [p] * 5 + [i] * 5 + [p])
    fn.restype = i
    return fn


def main() -> Dict[Tuple[str, str, str], List[float]]:
    print(f"device: {require_cuda()}")
    names = [(k, "committed") for k in SHAPES] + list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(lambda kv: build(*kv), names)))
    stream = torch.cuda.current_stream().cuda_stream
    times: Dict[Tuple[str, str, str], List[float]] = {}
    for kernel, (M, K, N, R) in SHAPES.items():
        x = inputs(M, K, N)
        order = [v for k, v in names if k == kernel]
        for dt, a, b in (("int8", x["a8"], x["b8"]), ("bf16", x["abf"], x["bbf"])):
            out_dtype = torch.int32 if dt == "int8" else torch.float32
            out = torch.empty((M, N), dtype=out_dtype, device="cuda")
            parts = torch.empty((8, M, N), dtype=out_dtype, device="cuda")
            bt = torch.empty((N, K), dtype=a.dtype, device="cuda")
            bf16 = int(dt == "bf16")
            for variant in order + order[::-1]:
                fn = libs[(kernel, variant)]
                if kernel == "dot_grid":
                    args = (a.data_ptr(), b.data_ptr(), bt.data_ptr(), out.data_ptr(), M, N, K,
                            bf16, stream)
                else:
                    args = (a.data_ptr(), b.data_ptr(), bt.data_ptr(), parts.data_ptr(),
                            out.data_ptr(), M, N, K, R, bf16, stream)
                err = fn(*args)
                if err != 0:
                    raise RuntimeError(f"{kernel} {variant} {dt}: launch failed, {err}")
                times.setdefault((kernel, dt, variant), []).append(
                    best_ms(lambda: fn(*args)))
            ops = 2.0 * R * M * N * K
            for variant in order:
                ts = times[(kernel, dt, variant)]
                ms = min(ts)
                print(f"variant {kernel} {dt} {variant}: {ms:.4f} ms ({ops / ms / 1e9:.1f} "
                      f"T(FL)OP/s; turns {', '.join(f'{t:.4f}' for t in ts)})")
    return times


if __name__ == "__main__":
    main()
