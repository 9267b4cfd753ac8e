"""Timings of variants of the grouped sampler kernels, to show what holds them back.

Each variant is a copy of ``csrc/bilinear_sample.cu`` with a few lines changed, built with
the port's flags beside the committed kernels, and its forward and its backward launched
alone (no autograd, no Python between the launches) on a config-4 step's 12 warps
(``tools/sampler_units.py``: B=10, 224x480 down to 28x60; the backward, dcoords of the 8
warps that need them) and on a config-3 step's 4, in turns (committed, variants, variants
reversed, committed), the best of 5 CUDA-event windows of 20 launches. Each variant's
outputs are held to the committed kernels' (out, wmask and dcoords bit-equal, no NaN):
  * ``no interleave``: each member's tiles one after another, the warps of one image not
    interleaved;
  * ``scalar coords``: two 8-byte coordinate loads a thread, not one of 16 bytes;
  * ``backward 72 registers``: the backward without its ``__launch_bounds__(256, 4)``, as
    first built (3 blocks of 256 threads a SM at 72 registers, from 4 at 64);
  * ``forward 40 registers``: ``__launch_bounds__(256, 6)`` on the forward (6 blocks a SM,
    from 5 at its 48);
  * ``direct out stores``: the forward's out stored by each thread straight from its
    registers, as first built (each of a thread's six stores at C = 3 writes 4 bytes, 24
    bytes from its neighbour's), not staged in shared memory for 16-byte stores;
  * ``no out stores``: the forward computes every channel but stores none; it leaves out
    work, so its out is not the committed kernels'.

Usage: python -m tf_depth_estimation_torch.tools.sampler_variants
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

import torch

from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.tools import sampler_units
from tf_depth_estimation_torch.tools.common import best_ms, build_variant, require_cuda

SOURCE = "bilinear_sample.cu"
# variant -> [(file, old text, new text)]
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "no interleave": [(SOURCE, "  *local = r / last.ways;\n  return k - last.lane + r % last.ways;",
                       "  const int per = (int)((last.n + TILE - 1) / TILE);\n"
                       "  *local = r % per;\n  return k - last.lane + r / per;")],
    "scalar coords": [(SOURCE, "  if (m.vec && two) return __ldg(", "  if (false) return __ldg(")],
    "backward 72 registers": [(SOURCE, "__global__ void __launch_bounds__(THREADS, 4)\n"
                               "bilinear_group_backward(",
                               "__global__ void __launch_bounds__(THREADS)\n"
                               "bilinear_group_backward(")],
    "forward 40 registers": [(SOURCE, "__global__ void __launch_bounds__(THREADS)\n"
                              "bilinear_group_forward(",
                              "__global__ void __launch_bounds__(THREADS, 6)\n"
                              "bilinear_group_forward(")],
    "direct out stores": [(SOURCE, "    const bool staged = m.C <= STAGE_C;",
                           "    const bool staged = false;")],
    "no out stores": [(SOURCE, "    const bool staged = m.C <= STAGE_C;",
                       "    const bool staged = false;"),
                      (SOURCE, "    out[c] = acc;", "    if (acc == -12345.f) out[c] = acc;")],
}
# variants that leave out work: their outputs are not the committed kernels'
LEAVE_OUT = ("no out stores",)
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "sampler_variants")


def build(variant: str):
    """The variant's (forward, backward) launch functions, typed."""
    path = _build.build("bilinear_sample")["path"] if variant == "committed" else \
        build_variant("bilinear_sample", VARIANTS[variant],
                      os.path.join(OUT, variant.replace(" ", "_")))
    lib = ctypes.CDLL(path)
    fns = (lib.bilinear_group_forward_launch, lib.bilinear_group_backward_launch)
    for fn in fns:
        fn.argtypes, fn.restype = [ctypes.c_char_p, ctypes.c_void_p], ctypes.c_int
    return fns


def unit(warps: List[tuple], seed: int = 1) -> dict:
    """The descriptors of one forward and one backward launch over ``warps``, the buffers
    they write and the tensors they read: {"fwd", "bwd" (packed groups), "outs" (out, wmask
    and dcoords), "members" (which hold the cotangents alive while the descriptors point at
    them)}."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    outs, fwd, bwd = [], [], []
    for imgs, coords, grad in warps:
        B, Ht, Wt, _ = coords.shape
        out = torch.empty((B, Ht, Wt, imgs.shape[3]), device="cuda")
        wmask = torch.empty((B, Ht, Wt, 1), device="cuda")
        fwd.append((imgs, coords, out, wmask, None, None, None, None))
        outs += [out, wmask]
        if grad:
            dout = torch.randn(out.shape, device="cuda", generator=g)
            dcoords = torch.empty_like(coords)
            bwd.append((imgs, coords, None, None, dout, None, dcoords, None))
            outs.append(dcoords)
    return {"fwd": bs._pack(fwd), "bwd": bs._pack(bwd), "outs": outs, "members": fwd + bwd}


def main() -> dict:
    smi = require_cuda()
    names = ["committed", *VARIANTS]
    libs = {n: build(n) for n in names}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = {}
    for label, warps in sampler_units.units("cuda").items():
        u = unit(warps)
        ref = None
        times: Dict[str, dict] = {n: {"fwd": [], "bwd": []} for n in names}
        for n in [*names, *names[::-1]]:
            fwd, bwd = libs[n]
            for t in u["outs"]:
                t.fill_(float("nan"))
            launch = lambda fn, desc: fn(desc, stream())
            for part, fn in (("fwd", fwd), ("bwd", bwd)):
                if launch(fn, u[part]) != 0:
                    raise RuntimeError(f"{n}: {part} launch refused")
                times[n][part].append(best_ms(lambda: launch(fn, u[part]), iters=20))
            torch.cuda.synchronize()
            got = [t.clone() for t in u["outs"]]
            if ref is None:
                ref = got
            times[n]["same"] = all(torch.equal(a, b) and not bool(a.isnan().any())
                                   for a, b in zip(got, ref))
        for n in names:
            t = times[n]
            fwd_ms, bwd_ms = (sum(t[p]) / len(t[p]) for p in ("fwd", "bwd"))
            rows[(label, n)] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "same": t["same"]}
            print(f"variant {label} {n}: forward {fwd_ms:.4f} ms ("
                  + "/".join(f"{x:.4f}" for x in t["fwd"]) + f"), backward {bwd_ms:.4f} ms ("
                  + "/".join(f"{x:.4f}" for x in t["bwd"]) + f"); the committed kernels' "
                  f"bits, no NaN: {t['same'] if n not in LEAVE_OUT else 'not checked'} [{smi}]")
        bf = sampler_units.unit_bound(warps, False)[0]
        bb = sampler_units.unit_bound(warps, True)[0]
        print(f"variant {label}: bound forward {bf:.4f} ms, backward {bb:.4f} ms (bytes) "
              f"[{smi}]")
    return rows


if __name__ == "__main__":
    main()
