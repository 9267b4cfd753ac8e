#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time the CUDA kernel,
then serve depth4 DispNet at 576x384 with the committed teacher weights.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: nvcc -> shared library -> ctypes for the kernel, with nvcc's wall time and the
     -Xptxas -v register and shared-memory lines;
  3. kernel vs plain: ``fused_tail`` against ``fused_tail_reference`` at the tail's shapes
     of a 576x384 batch of 8, teacher weights, seeded inputs, in float32 and bf16;
  4. whole forward: ``fast_depth_forward`` in float32 with the fused tail against the
     plain module forward (``DispNet`` eval, native tail) at rtol = atol = 2e-4;
  5. serving, the main path: a ``DepthPredictor`` answers requests of 8, 5 and 1 frames;
     the kernels' launch counts are set to 0 just before and read just after;
  6. times with CUDA events: the kernel, its plain version and its bound at batch 8 and 64,
     and the bf16 forward's frames/s at batch 64.
The line before the last is one JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. There is no CPU path: without CUDA it exits non-zero.
TF32 is off throughout, so the float32 checks are float32 and not TF32.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from tf_depth_estimation_torch.infer.fast import fast_depth_forward, fold_weights, folded_forward
from tf_depth_estimation_torch.infer.predictor import DepthPredictor
from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.fused_tail import (
    N_PARAMS,
    fused_tail,
    fused_tail_reference,
)
from tf_depth_estimation_torch.utils.npz import load_variables_npz
from tf_depth_estimation_torch.weights import dispnet_from_variables

ROOT = os.path.dirname(os.path.abspath(__file__))
TEACHER = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")
HEIGHT, WIDTH = 384, 576
SEED = 0
# fused_tail vs its plain version, (max, mean) abs error; the limits of
# tests/test_torch_fused_tail.py. float32: the same products summed in another order over
# 153 + 144 terms. bf16: the intermediates are rounded to bf16 (1/256 relative) at two
# points, and a different f32 sum can round a value to the neighbouring bf16 number; a
# kernel that skipped the rounding points would miss the mean limit.
TOL_TAIL = {torch.float32: (2e-5, 1e-6), torch.bfloat16: (1e-2, 1e-4)}
TOL_FORWARD = 2e-4  # rtol = atol of tests/test_fast_infer.py
# the bf16 serving forward against the float32 module forward, (max, mean) abs error: bf16
# activations and weights through 31 convolutions, on disparities in [0, 4]. An H100 run
# of this script measured max 9.0e-3 and mean 2.23e-3 at 576x384; the limits allow about
# 2.5x that.
TOL_SERVING = (2.5e-2, 5e-3)
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32, PEAK_BF16, PEAK_HBM = 67e12, 989e12, 3.35e12


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke "
                         "runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": smi.splitlines()[0]}
    print(f"device: {info['kind']} x{info['count']}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {info['smi']}")
    return info


def phase_build() -> None:
    entry = _build.build("fused_tail")
    print(f"build: fused_tail: nvcc {entry['seconds']:.2f} s wall")
    for line in entry["log"].splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"  {line.strip()}")


def tail_inputs(batch: int, dtype: torch.dtype, device) -> tuple:
    g = np.random.RandomState(SEED)
    h, w = HEIGHT // 2, WIDTH // 2
    x2 = np.abs(g.randn(batch, h, w, 32)).astype(np.float32)  # icnv2's output is post-ReLU
    d2 = (g.rand(batch, h, w, 1) * 4.0).astype(np.float32)    # sigmoid * 4
    return (torch.from_numpy(x2).to(device=device, dtype=dtype),
            torch.from_numpy(d2).to(device))


def phase_kernel(folded_by_dtype: dict, batch: int = 8) -> dict:
    errs = {}
    for dt, folded in folded_by_dtype.items():
        x2, d2 = tail_inputs(batch, dt, "cuda")
        got = fused_tail(x2, d2, folded["tail"])
        ref = fused_tail_reference(x2, d2, folded["tail"])
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fused_tail {dt}: non-finite output")
        err = (got - ref).abs().max().item()
        mean = (got - ref).abs().mean().item()
        tol_max, tol_mean = TOL_TAIL[dt]
        print(f"kernel fused_tail {str(dt)[6:]} B={batch} {tuple(x2.shape)}: abs err max "
              f"{err:.3e}, mean {mean:.3e} vs fused_tail_reference, tolerance max "
              f"{tol_max:.0e}, mean {tol_mean:.0e}")
        if err > tol_max or mean > tol_mean:
            raise AssertionError(f"fused_tail {dt}: abs err max {err}, mean {mean} beyond "
                                 f"{tol_max}, {tol_mean}")
        errs[dt] = err
    return errs


def _frames(n: int, height: int, width: int, seed: int = SEED) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, height, width, 3), np.uint8)


def phase_forward(variables: dict, device, height: int = HEIGHT, width: int = WIDTH,
                  batch: int = 8) -> dict:
    """f32 fast forward (fused and native tails) vs the plain module forward."""
    frames = torch.from_numpy(_frames(batch, height, width))
    before = fused_tail.launches
    with torch.inference_mode():
        fused = fast_depth_forward(variables, frames, dtype=torch.float32, tail="fused",
                                   device=device)
        launches = fused_tail.launches - before
        native = fast_depth_forward(variables, frames, dtype=torch.float32, tail="native",
                                    device=device)
        model = dispnet_from_variables(variables, device=device)
        ref = [r.permute(0, 2, 3, 1) for r in
               model(frames.to(device).permute(0, 3, 1, 2).float())]
    worst = 0.0
    for tail, got in (("fused", fused), ("native", native)):
        for i, (g, r) in enumerate(zip(got, ref), start=1):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"forward {tail} d{i}: shape {tuple(g.shape)} vs "
                                     f"{tuple(r.shape)} or non-finite values")
            err = (g - r).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(g, r, rtol=TOL_FORWARD, atol=TOL_FORWARD):
                raise AssertionError(f"forward {tail} d{i}: max abs err {err} beyond "
                                     f"rtol = atol = {TOL_FORWARD}")
    print(f"forward f32 {height}x{width} B={batch}: fused and native tails match the "
          f"module forward, max abs err {worst:.3e} (rtol = atol = {TOL_FORWARD}); "
          f"fused_tail launches {launches}")
    return {"max_abs_err": worst, "launches": launches}


def phase_serving(variables: dict, device, height: int = HEIGHT, width: int = WIDTH,
                  batch: int = 8) -> dict:
    """DepthPredictor (bf16, fused tail) answers requests of ``batch`` (at least 5), 5
    and 1 frames; each answer is held against the float32 module forward of the frames."""
    if batch < 5:
        raise ValueError(f"serving needs a batch of at least 5, got {batch}")
    frames = _frames(batch, height, width, seed=SEED + 1)
    with torch.inference_mode():
        model = dispnet_from_variables(variables, device=device)
        ref = model(torch.from_numpy(frames).to(device).permute(0, 3, 1, 2).float())
        ref = ref[0][:, 0].cpu().numpy()
    pred = DepthPredictor(variables["params"], variables["batch_stats"], height=height,
                          width=width, batch_size=batch, dtype=torch.bfloat16,
                          device=device)
    full = None
    for n in (batch, 5, 1):
        t0 = time.perf_counter()
        out = pred.predict_array(frames[:n])
        ms = (time.perf_counter() - t0) * 1e3
        if out.shape != (n, height, width) or not np.isfinite(out).all():
            raise AssertionError(f"serving {n} frames: shape {out.shape} or non-finite")
        diff = np.abs(out - ref[:n])
        err, mean = float(diff.max()), float(diff.mean())
        if err > TOL_SERVING[0] or mean > TOL_SERVING[1]:
            raise AssertionError(f"serving {n} frames: abs err max {err}, mean {mean} to "
                                 f"the f32 module forward beyond {TOL_SERVING}")
        full = out if full is None else full
        # a request padded to a bucket of ``batch`` runs at the full request's shape, so
        # each frame gets exactly what the full request gave it
        if n < batch and 1 << (n - 1).bit_length() == batch:
            pad_diff = float(np.abs(out - full[:n]).max())
            if pad_diff != 0.0:
                raise AssertionError(f"serving {n} frames differs from the full batch "
                                     f"by {pad_diff}")
        print(f"serving: {n} frames -> {out.shape} float32, finite, range "
              f"[{out.min():.3f}, {out.max():.3f}], {ms:.1f} ms host clock, abs err max "
              f"{err:.3e}, mean {mean:.3e} to the f32 module forward (tolerance max "
              f"{TOL_SERVING[0]:.1e}, mean {TOL_SERVING[1]:.1e})")
    return {"frames": batch + 5 + 1}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tail_bound(batch: int, dtype: torch.dtype) -> tuple:
    """Least time (ms) an H100 SXM needs for the tail: each input read and the output
    written once, upcnv1/icnv1/disp1 multiply-adds at the peak for their operand type."""
    h, w = HEIGHT // 2, WIDTH // 2
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = batch * (h * w * 32 * esize + h * w * 4 + 4 * h * w * 4) + N_PARAMS * 4
    f_up = batch * h * w * 9 * 32 * 16 * 2
    f_ic = batch * 4 * h * w * 9 * 17 * 16 * 2
    f_d1 = batch * 4 * h * w * 9 * 16 * 2      # bf16 activations x f32 weights: f32
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops = (f_up + f_ic) / peak + f_d1 / PEAK_F32
    t_bytes = nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_times(folded_by_dtype: dict, smi: str) -> dict:
    rows = {}
    for batch in (8, 64):
        for dt, folded in folded_by_dtype.items():
            x2, d2 = tail_inputs(batch, dt, "cuda")
            p = folded["tail"]
            iters = 20 if batch == 8 else 5
            ms = time_ms(lambda: fused_tail(x2, d2, p), iters)
            plain = time_ms(lambda: fused_tail_reference(x2, d2, p), iters)
            bound, by = tail_bound(batch, dt)
            rows[(batch, dt)] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                                 "bound_by": by}
            print(f"time fused_tail {str(dt)[6:]} B={batch}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), kernel/bound "
                  f"{ms / bound:.1f}x [{smi}]")
            del x2, d2
    batch = 64
    folded = folded_by_dtype[torch.bfloat16]
    x = torch.from_numpy(_frames(batch, HEIGHT, WIDTH)).cuda()
    for tail in ("fused", "native"):
        with torch.inference_mode():
            ms = time_ms(lambda: folded_forward(folded, x, tail=tail), 5)
        print(f"time forward bf16 {HEIGHT}x{WIDTH} B={batch} tail={tail}: {ms:.3f} ms/batch,"
              f" {batch / ms * 1e3:.1f} frames/s [{smi}]")
    return rows


def main() -> None:
    t_start = time.perf_counter()
    info = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    variables, meta = load_variables_npz(TEACHER)
    print(f"weights: {os.path.relpath(TEACHER, ROOT)} {meta}")
    folded = {dt: fold_weights(variables, dtype=dt, device="cuda")
              for dt in (torch.float32, torch.bfloat16)}
    errs = phase_kernel(folded)
    fwd = phase_forward(variables, "cuda")
    if fwd["launches"] < 1:
        raise AssertionError("the f32 forward did not launch fused_tail")

    fused_tail.launches = 0  # the main path: serving through DepthPredictor
    phase_serving(variables, "cuda")
    torch.cuda.synchronize()
    launches = {"fused_tail": fused_tail.launches}
    print(f"serving launches: {launches}")
    if launches["fused_tail"] < 1:
        raise AssertionError("serving did not launch fused_tail")

    rows = phase_times(folded, info["smi"])
    main_row = rows[(8, torch.bfloat16)]  # the serving path's shapes and dtype
    kernels = [{
        "name": "fused_tail", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/fused_tail.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_tail.py:112",
        "launches": launches["fused_tail"], "max_abs_err": errs[torch.bfloat16],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
    }]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {info['smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}))


if __name__ == "__main__":
    main()
