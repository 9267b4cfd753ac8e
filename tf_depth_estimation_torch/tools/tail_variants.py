"""Timings of variants of the bf16 decoder-tail kernel, to show what holds it back.

Each variant is a copy of ``csrc/fused_tail.cu`` (and the headers of ``csrc/``) with a few
lines changed, built with the port's flags beside the committed kernel, and timed on the
serving shapes (x2 [64, 192, 288, 32] bf16, d2 [64, 192, 288, 1]; 576x384 outputs) in
turns (committed, variants, variants reversed, committed), the best of 5 CUDA-event
windows of 10 calls each. A variant that leaves out work says what that work costs on the
critical path; its output is wrong and not checked (``chip_smoke.py`` checks the
committed kernel):
  * ``no d2u``: the d2 loads and the upsample leave zeros in the d2u rows;
  * ``no upcnv1 mma`` / ``no icnv1 mma``: the wgmma of that conv are skipped, its
    ldmatrix loads and epilogue stay;
  * ``no icnv1``: step B is skipped whole;
  * ``no disp1``: step C computes and stores nothing;
  * ``no waits``: the block never waits for its x2 rows (the TMA still loads them);
  * ``2 blocks a SM`` / ``1 block a SM``: the grid holds that many blocks a SM instead of
    as many as fit (three).

Usage: python -m tf_depth_estimation_torch.tools.tail_variants [--batch 64]
"""
from __future__ import annotations

import argparse
import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.fused_tail import prepare_tail_params
from tf_depth_estimation_torch.tools.common import best_ms, build_variant, require_cuda

SOURCE = "fused_tail.cu"
# variant -> [(file, old text, new text)]
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "no d2u": [(SOURCE, "bool d2u_in = load_d2(db, U0 - 1, c0);", "bool d2u_in = false;"),
               (SOURCE, "if (k <= t.seg) d2u_in = load_d2(db, U + 1, c0);", "")],
    "no upcnv1 mma": [(SOURCE, "    mma_n32_ss(acc, desc(",
                       "    if (R == -12345) mma_n32_ss(acc, desc(")],
    "no icnv1 mma": [(SOURCE, "      mma_n16_ss(acc, desc(",
                      "      if (Ry == -12345) mma_n16_ss(acc, desc("),
                     (SOURCE, "    mma_n16(acc, a,", "    if (Ry == -12345) mma_n16(acc, a,")],
    "no icnv1": [(SOURCE, "if (k >= 1) icnv1(", "if (false) icnv1(")],
    "no disp1": [(SOURCE, "        disp1_pair(smem,", "        if (k < 0) disp1_pair(smem,")],
    "no waits": [(SOURCE, "      mbar_wait(bar(T0 + k + 1), parity(T0 + k + 1));", ""),
                 (SOURCE, "        mbar_wait(bar(T0 + k), parity(T0 + k));", "")],
    "2 blocks a SM": [(SOURCE, "const int slots = std::max(per_sm, 1) * sm_count();",
                       "const int slots = std::min(std::max(per_sm, 1), 2) * sm_count();")],
    "1 block a SM": [(SOURCE, "const int slots = std::max(per_sm, 1) * sm_count();",
                      "const int slots = sm_count();")],
}
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "tail_variants")


def build(variant: str):
    """The variant's ``fused_tail_launch``, typed."""
    lib = build_variant("fused_tail", VARIANTS.get(variant, []),
                        os.path.join(OUT, variant.replace(" ", "_")))
    fn = ctypes.CDLL(lib).fused_tail_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, i, i, i, i, f, f, p]
    fn.restype = i
    return fn


def inputs(batch: int, h: int = 192, w: int = 288, seed: int = 0):
    """Seeded x2 (post-ReLU, bf16), d2 (in [0, 4]) and the tail's parameters."""
    g = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(g.randn(*s).astype(np.float32)).cuda()
    params = prepare_tail_params(
        t(32, 16, 3, 3) * 0.1, (t(16).abs() + 0.5, t(16) * 0.1), t(16, 17, 3, 3) * 0.1,
        (t(16).abs() + 0.5, t(16) * 0.1), t(1, 16, 3, 3) * 0.1, t(1) * 0.1, torch.bfloat16)
    x2 = t(batch, h, w, 32).abs().to(torch.bfloat16)
    d2 = torch.from_numpy((g.rand(batch, h, w, 1) * 4.0).astype(np.float32)).cuda()
    return x2, d2, params


def main(argv=None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    print(f"device: {require_cuda()}")
    names = ["committed", *VARIANTS]
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    x2, d2, params = inputs(args.batch)
    B, h, w, _ = x2.shape
    out = torch.empty((B, 2 * h, 2 * w, 1), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    call_args = (x2.data_ptr(), d2.data_ptr(), params["packed"].data_ptr(),
                 params["disp1_host"].data_ptr(), out.data_ptr(), B, h, w, 1, 4.0, 0.0, stream)
    times: Dict[str, List[float]] = {}
    ref = None
    for name in names + names[::-1]:
        fn = libs[name]
        err = fn(*call_args)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed, {err}")
        torch.cuda.synchronize()
        if ref is None:
            ref = out.clone()
        elif name not in times:
            print(f"variant {name}: max abs difference from committed "
                  f"{(out - ref).abs().max().item():.3e}")
        times.setdefault(name, []).append(best_ms(lambda: fn(*call_args)))
    for name in names:
        ts = times[name]
        print(f"variant fused_tail bf16 B={B} {name}: {min(ts):.4f} ms (turns "
              f"{', '.join(f'{t:.4f}' for t in ts)})")
    return times


if __name__ == "__main__":
    main()
