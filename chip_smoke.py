#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time the CUDA kernels,
serve depth4 DispNet at 576x384 with the committed teacher weights, train config 4
(depth10_flow, joint depth + optical flow) at 224x480, train config 2 (depth4, supervised
depth with in-loop validation) at 240x720, and train both phases of split_training
(DepthPoseNet pairwise, then depth4 over [coarse depth | image]) at 192x256.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: nvcc -> shared library -> ctypes for every kernel, one nvcc per source, all
     started together, with nvcc's wall times and the -Xptxas -v lines;
  3. kernel vs plain: ``fused_tail`` against ``fused_tail_reference`` at the tail's shapes
     of a 576x384 batch of 8, teacher weights, seeded inputs, in float32 and bf16;
  4. whole forward: ``fast_depth_forward`` in float32 with the fused tail against the
     plain module forward (``DispNet`` eval, native tail) at rtol = atol = 2e-4;
  5. serving, a main path: a ``DepthPredictor`` answers requests of 8, 5 and 1 frames;
     the kernels' launch counts are set to 0 just before and read just after;
  6. times with CUDA events: the tail kernel, its plain version and its bound at batch 8
     and 64, and the bf16 forward's frames/s at batch 64;
  7. kernel vs plain: ``bilinear_sample`` against ``bilinear_sample_reference`` at config
     4's shapes (B=10, 224x480x3, pixels in [0, 255]) with the coords of a real depth warp,
     wild coords, exact-integer coords and an odd non-square size; forward and dcoords;
  8. training, a main path: the config-4 CLI (``train/experiments/optflow_combine.py``,
     bf16, batch 10, 240x720 JPEG pairs read and resized to 224x480) on a synthetic
     dataset for 5 steps, with the launch counts set to 0 before and read after (12
     ``bilinear_sample`` launches and 12 forward and 12 backward ``smoothness_fused``
     launches a step); every loss component finite; the checkpoint read back into
     ``DispNet(depth10_flow)`` and its eval forward finite;
  9. step parity: one float32 step with the kernels against one with the plain sampler
     and smoothness term from one init and batch, and the bf16 step's loss against the
     float32 one;
 10. times: the sampler kernel, its plain version, ``grid_sample`` and the bound at scale
     0 and over a step's 12 calls; ms/step and frames/s of the bf16 training step with
     the kernel and with the plain sampler;
 11. kernel vs plain: ``smoothness_fused`` (forward and backward) against the plain term
     at config 2's four scales (B=10, 240x720 down to 30x90), on a strided C=1 flow plane
     of an NCHW [B, 2, H, W] head, a constant and a piecewise-constant map (exact ties)
     and an odd 37x53 map: the forward within rtol 1e-5 of the float32 and the float64
     plain term, the backward within 1e-6 max|g| of autograd of the plain term, and the
     same bits in two runs;
 12. training, a main path: the config-2 CLI (``train/experiments/depth_only.py``, bf16,
     batch 10, 240x720) on the same dataset for 5 steps with ``--validation_check 2``,
     the launch counts set to 0 before and read after (4 forward and 4 backward
     ``smoothness_fused`` launches a step, 4 forward a validation); every train and val
     record finite; the checkpoint read back into ``DispNet(depth4)``;
 13. times: the smoothness kernels, the plain term and the bound, forward and backward,
     at config 2's scale 0 and over a step's calls in configs 2 and 4; ms/step of the
     bf16 config-2 step with the kernels and with the plain term, in turns;
 14. kernel vs plain: ``sig_l2_fused`` (forward, and backward for pred and gt) against
     the plain composition (``ops/sig.py``) at phase 2's four scales (B=1, 192x256 down
     to 24x32, delta 2), the 5-delta ``full_scales`` call at 192x256 (B=1 and B=8), a
     coarse map where the deltas reach past the map, an odd 37x53 map and a strided C=1
     plane: the forward within rtol 1e-5 of the float32 and the float64 plain version,
     the backward within 1e-6 of autograd of the plain version and equal, bit for bit, to
     ``sig_l2_backward_reference``, and the same bits in two runs;
 15. training, two main paths: split_training's phase 1 (the truncated DepthPoseNet
     pairwise) and phase 2 (depth4 DispNet over [coarse depth | image]), bf16, batch 1,
     192x256, 5 steps each through ``train_pair`` and ``train_single``, the functions the
     CLI's ``main`` calls, with the launch counts set to 0 before each phase and read
     after it (2 forward and 2 backward ``sig_l2_fused`` launches a phase-1 step, 4 and 4
     a phase-2 step); every loss component finite; both checkpoint groups read back into
     ``DepthPoseNet`` and a 4-channel ``DispNet(depth4)`` with finite eval forwards;
 16. step parity: one float32 step of each phase with the kernel against one with the
     plain sig composition from one init and batch, and the bf16 step's loss against the
     float32 one;
 17. times: the sig kernels, the plain composition and the bound, forward and forward +
     backward, at phase 2's four step calls and at the 5-delta 192x256 B=8 call; ms/step
     of each phase's bf16 step with the kernel and with the plain version, in turns; and
     launches a step of each phase from ``train/profile_step.py``.
The GPU machine has no ``h5py``, so the smoke cannot write the DeMoN HDF5 files that the
split_training CLI reads (``data/demon.py``): phase 15 feeds the CLI's phase functions
batches of synthetic scenes, augmented and preprocessed by ``data/demon.py``'s own
``augment`` and ``preprocess``; the CPU tests run the CLI on an HDF5 file.
The line before the last is one JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. There is no CPU path: without CUDA it exits non-zero.
TF32 is off throughout, so the float32 checks are float32 and not TF32.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader, to_device
from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
from tf_depth_estimation_torch.geometry.warp import projective_inverse_warp
from tf_depth_estimation_torch.infer.fast import fast_depth_forward, fold_weights, folded_forward
from tf_depth_estimation_torch.infer.predictor import DepthPredictor
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.bilinear_sample import (
    bilinear_sample,
    bilinear_sample_reference,
)
from tf_depth_estimation_torch.ops.fused_tail import (
    N_PARAMS,
    fused_tail,
    fused_tail_reference,
)
from tf_depth_estimation_torch.ops.schedules import exponential_decay
from tf_depth_estimation_torch.ops.sig import sig_l2_plain
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_backward_reference, sig_l2_fused
from tf_depth_estimation_torch.ops.smoothness import (
    second_order_smoothness,
    smoothness_backward_reference,
    smoothness_fused,
)
from tf_depth_estimation_torch.train import profile_step
from tf_depth_estimation_torch.train.experiments import depth_only, optflow_combine, split_training
from tf_depth_estimation_torch.train.profile_step import demon_batch, plain_sig, plain_smoothness
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import (
    make_depth_only_step,
    make_optflow_combine_step,
    make_pairwise_step,
    make_single_depth_step,
)
from tf_depth_estimation_torch.utils.npz import load_variables_npz
from tf_depth_estimation_torch.weights import depth_pose_from_variables, dispnet_from_variables

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
# config 4, the training path (train/experiments/optflow_combine.py defaults): 240x720
# JPEG pairs read and resized to 224x480, batch 10, bf16
C4_HEIGHT, C4_WIDTH, C4_READ, C4_BATCH, C4_STEPS = 224, 480, (240, 720), 10, 5
LAUNCHES_PER_STEP = 12   # 3 warps (GT depth, predicted depth, flow) at each of 4 scales
# bilinear_sample vs its plain version, (max, mean) abs error: out on pixels in [0, 255],
# wmask in [0, 1]. The kernel rounds every product and sum on its own in the reference's
# order (__fmul_rn / __fadd_rn), as PyTorch's elementwise ops do, so it is expected to be
# exact; a sum contracted into FMAs would differ by up to ~2 ulp of 255 (3.05e-5) and of
# 1 (2.4e-7), which the limits allow, while a wrong tap or weight moves values by whole
# pixel differences.
TOL_SAMPLE = {"out": (3.1e-5, 1e-6), "wmask": (2.4e-7, 1e-8)}
# dcoords through the autograd function (corners from the kernel) vs autograd of the
# plain version: the same terms summed in another order, |dcoords| up to ~2e3 here
TOL_DCOORDS = dict(rtol=1e-5, atol=1e-5 * 255)
# one float32 step, kernel vs plain sampler, from one init and batch: the loss components
# come from identical forwards up to cuDNN's sum order (rtol 1e-5); after Adam's first
# step a parameter moved by ~lr * sign(g) in both, so every parameter is within 2 lr and
# all but 1 % within 1e-6 (tests/test_torch_train.py holds the port to JAX the same way)
TOL_STEP = {"loss_rtol": 1e-5, "param_atol": 1e-6, "param_share_off": 0.01}
# the bf16 step's first loss against the float32 one from the same init: bf16 activations
# (2^-8 relative) through ~45 convolutions; 0.08 % on the CPU at 64x96
TOL_BF16_LOSS = 0.02
# config 2, the second training path (train/experiments/depth_only.py defaults): 240x720
# pairs at their stored size, batch 10, bf16; validation every 2 steps at batch 1
C2_HEIGHT, C2_WIDTH, C2_BATCH, C2_STEPS, C2_VAL_CHECK = 240, 720, 10, 5, 2
# smoothness_fused launches (forward, backward): one term per depth head and scale in
# config 2, depth and both flow channels per scale in config 4; a validation runs 4
# forward
SMOOTH_PER_STEP = {"depth_only": (4, 4), "optflow_combine": (12, 12)}
SMOOTH_PER_VAL = 4
# smoothness_fused vs the plain term: the forward sums the same terms in another order
# (block partials, then a double sum), rtol 1e-5 as tests/test_pallas.py:69; the backward
# adds the same sgn(term) / (B count) contributions as autograd in another order, so it
# is within a few float32 ulp of max|g|
TOL_SMOOTH_FWD, TOL_SMOOTH_BWD = 1e-5, 1e-6
# split_training, the fourth and fifth paths (train/experiments/split_training.py
# defaults): DeMoN scenes at 192x256, batch 1, bf16; 5 steps of each phase
ST_HEIGHT, ST_WIDTH, ST_BATCH, ST_STEPS = 192, 256, 1, 5
# sig_l2_fused launches (forward, backward) a step: delta 2 at scales 2 and 3 in phase 1,
# at all four scales in phase 2
SIG_PER_STEP = {"pair": (2, 2), "single": (4, 4)}
# sig_l2_fused vs the plain composition: the forward sums the same per-pixel roots in
# another order (block partials, then a double sum), rtol 1e-5 as tests/test_pallas.py:56;
# the backward adds the same terms as autograd, rounded in another order, within 1e-6 of
# max|g| of autograd's gradient in each case (|g| is ~1e-6 to 1e-2 here, so an absolute
# 1e-6 as tests/test_pallas.py:66 would let a wrong B=8 gradient through); the gather
# formula is the kernel's arithmetic op for op, so the two are equal
TOL_SIG_FWD, TOL_SIG_BWD = 1e-5, 1e-6
FULL_SCALE_DELTAS = (1, 2, 4, 8, 16)
# the step at which the parity steps run: the sig weight ramps from 0 at step 0, so a
# step-0 parity would multiply the sig term's gradient by 0
PARITY_STEP = 1000
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


KERNELS = ("fused_tail", "bilinear_sample", "smoothness", "sig_l2")


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:   # one nvcc per source, all at once
        entries = dict(zip(KERNELS, ex.map(_build.build, KERNELS)))
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for name, entry in entries.items():
        print(f"build: {name}: nvcc {entry['seconds']:.2f} s wall")
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

def sample_bound(B: int, Hs: int, Ws: int, Ht: int, Wt: int, C: int,
                 corners: bool = False) -> tuple:
    """Least time (ms) an H100 SXM needs for one sampler call: imgs and coords read once,
    out and wmask (and the corner planes, when the backward needs them) written once;
    about 19 + 7 C float32 operations per output pixel."""
    n = B * Ht * Wt
    nbytes = 4 * (B * Hs * Ws * C + 2 * n + C * n + n + (4 * C * n if corners else 0))
    t_bytes, t_ops = nbytes / PEAK_HBM, n * (19 + 7 * C) / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def warp_coords(B: int, H: int, W: int, device, seed: int = SEED + 2) -> torch.Tensor:
    """The coords of a real depth warp: seeded depth in [0.8, 2.5], a translation of up to
    5 cm and a rotation of up to 0.02 rad about the optical axis, config 4's intrinsics."""
    g = np.random.RandomState(seed)
    depth = torch.from_numpy(g.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    K = torch.tensor([[0.9 * W, 0.0, W / 2], [0.0, 0.9 * W, H / 2], [0.0, 0.0, 1.0]])
    pose = torch.eye(4).repeat(B, 1, 1)
    a = torch.from_numpy(g.uniform(-0.02, 0.02, B).astype(np.float32))
    pose[:, 0, 0], pose[:, 0, 1], pose[:, 1, 0], pose[:, 1, 1] = a.cos(), -a.sin(), a.sin(), a.cos()
    pose[:, :3, 3] = torch.from_numpy(g.uniform(-0.05, 0.05, (B, 3)).astype(np.float32))
    img = torch.zeros((B, H, W, 1))
    warp = projective_inverse_warp(img.to(device), depth.to(device), pose.to(device),
                                   K.expand(B, 3, 3).contiguous().to(device), fmt="matrix")
    return warp.coords


def sampler_cases(device) -> dict:
    """name -> (imgs [B,Hs,Ws,3] in [0, 255], coords [B,Ht,Wt,2]) at config 4's shapes."""
    g = np.random.RandomState(SEED + 3)
    B, H, W = C4_BATCH, C4_HEIGHT, C4_WIDTH
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    imgs = t(g.rand(B, H, W, 3) * 255)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([gx, gy], -1)[None]
    return {
        "warp": (imgs, warp_coords(B, H, W, device)),
        "wild": (imgs, t(g.rand(B, H, W, 2) * [4 * W, 4 * H] - [2 * W, 2 * H])),
        "integer": (imgs, t(grid + g.randint(-3, 4, (B, H, W, 2)))),
        "odd": (t(g.rand(B, 37, 53, 3) * 255), t(g.rand(B, 29, 61, 2) * [55, 39] - 1)),
    }


def phase_sampler(device, smi: str) -> dict:
    """bilinear_sample vs bilinear_sample_reference: forward everywhere, dcoords on the
    real warp and on integer coords."""
    worst = {"out": 0.0, "wmask": 0.0, "dcoords": 0.0}
    for name, (imgs, coords) in sampler_cases(device).items():
        got = bilinear_sample(imgs, coords)
        ref = bilinear_sample_reference(imgs, coords)
        torch.cuda.synchronize()
        for what, g, r in zip(("out", "wmask"), got, ref):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"bilinear_sample {name} {what}: shape "
                                     f"{tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
            err, mean = (g - r).abs().max().item(), (g - r).abs().mean().item()
            tol_max, tol_mean = TOL_SAMPLE[what]
            print(f"kernel bilinear_sample {name} {tuple(imgs.shape)} at "
                  f"{tuple(coords.shape)}: {what} abs err max {err:.3e}, mean {mean:.3e} "
                  f"vs bilinear_sample_reference, tolerance max {tol_max:.1e}, mean "
                  f"{tol_mean:.0e} [{smi}]")
            if err > tol_max or mean > tol_mean:
                raise AssertionError(f"bilinear_sample {name} {what}: abs err max {err}, "
                                     f"mean {mean} beyond {tol_max}, {tol_mean}")
            worst[what] = max(worst[what], err)
        if name not in ("warp", "integer"):
            continue
        g = np.random.RandomState(SEED + 4)
        dout = torch.from_numpy(g.randn(*imgs.shape[:1], *coords.shape[1:3], 3)
                                .astype(np.float32)).to(device)
        dmask = torch.from_numpy(g.randn(*coords.shape[:3], 1).astype(np.float32)).to(device)
        grads = []
        for fn in (bilinear_sample, bilinear_sample_reference):
            c = coords.clone().requires_grad_(True)
            out, mask = fn(imgs, c)
            torch.autograd.backward([out, mask], [dout, dmask])
            grads.append(c.grad)
        err = (grads[0] - grads[1]).abs().max().item()
        print(f"kernel bilinear_sample {name}: dcoords abs err max {err:.3e} vs autograd "
              f"of the plain version (|dcoords| max {grads[1].abs().max().item():.1f}), "
              f"tolerance rtol {TOL_DCOORDS['rtol']:.0e}, atol {TOL_DCOORDS['atol']:.2e} "
              f"[{smi}]")
        torch.testing.assert_close(grads[0], grads[1], **TOL_DCOORDS)
        worst["dcoords"] = max(worst["dcoords"], err)
    return worst


def write_dataset(root: str, batch: int = C4_BATCH, read_hw=C4_READ) -> str:
    """A synthetic colon pair dataset (JPEG pairs, raw depth, intrinsics, projections)
    with ``batch`` training pairs at ``read_hw``."""
    return write_colon_pair_dataset(os.path.join(root, "colon"), num_frames=2 * batch,
                                    H=read_hw[0], W=read_hw[1], seed=SEED)


def phase_training(device, dataset: str, *, height: int = C4_HEIGHT,
                   width: int = C4_WIDTH, read_hw=C4_READ, batch: int = C4_BATCH,
                   steps: int = C4_STEPS, dtype: str = "bfloat16", smi: str = "") -> dict:
    """The config-4 CLI for ``steps`` steps; every loss component finite; the checkpoint
    read back into depth10_flow DispNet and its eval forward finite."""
    ckpt = os.path.join(os.path.dirname(dataset), "checkpoints")
    t0 = time.perf_counter()
    state, _ = optflow_combine.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size", str(batch),
        "--max_steps", str(steps), "--summary_freq", "1", "--save_latest_freq", str(steps),
        "--image_height", str(read_hw[0]), "--image_width", str(read_hw[1]),
        "--resized_height", str(height), "--resized_width", str(width),
        "--dtype", dtype, "--device", str(device), "--seed", str(SEED)])
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    comps = ("total", "depth", "smooth", "optflow", "pixel")
    if state.step != steps or len(records) != steps or not all(
            np.isfinite(r[k]) for r in records for k in comps):
        raise AssertionError(f"training: step {state.step}, {len(records)} records, "
                             f"losses {records}")
    for r in records:
        print(f"training step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in comps)
              + f" [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = dispnet_from_variables(variables, device=device)
    x = torch.from_numpy(next(iter(BatchLoader(
        PairDepthDataset(dataset, image_height=read_hw[0], image_width=read_hw[1],
                         resized_height=height, resized_width=width),
        batch, num_workers=1)))["tgt_image"]).to(device).permute(0, 3, 1, 2)
    with torch.no_grad():
        outs = model(x)
    shapes = [(batch, c, height >> s, width >> s) for c in (1, 2) for s in range(4)]
    if model.variant.name != "depth10_flow" or [tuple(o.shape) for o in outs] != shapes \
            or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"checkpoint step {meta.get('step')}: {model.variant.name}, "
                             f"outputs {[tuple(o.shape) for o in outs]} or non-finite")
    print(f"training: {steps} steps of config 4 ({dtype}, {height}x{width}, batch {batch}) "
          f"through the CLI in {seconds:.1f} s host clock; every loss component finite; "
          f"model-{steps}.npz read back into DispNet({model.variant.name}), eval forward "
          f"finite, d1 in [{outs[0].min().item():.3f}, {outs[0].max().item():.3f}] [{smi}]")
    return {"steps": steps, "seconds": seconds}


def first_batch(dataset: str, device) -> dict:
    ds = PairDepthDataset(dataset, image_height=C4_READ[0], image_width=C4_READ[1],
                          resized_height=C4_HEIGHT, resized_width=C4_WIDTH)
    return to_device(next(iter(BatchLoader(ds, C4_BATCH, num_workers=1))), device)


def config4_state(device, sd: dict, dtype: torch.dtype):
    model = DispNet(DispNetVariant.depth10_flow(), dtype=dtype)
    model.load_state_dict(sd)
    return create_train_state(model.to(device))


def config4_step(sampler: str, batch: dict):
    h, w = batch["tgt_image"].shape[1:3]
    return make_optflow_combine_step(dataclasses.replace(
        LossWeights.optflow_combine(), height=h, width=w, sampler=sampler))


def phase_step_parity(device, batch: dict, smi: str) -> dict:
    """One f32 step with the kernels vs one with the plain sampler and smoothness term from
    one init and batch; the bf16 step's loss against the f32 one."""
    sd = copy.deepcopy(DispNet(DispNetVariant.depth10_flow(),
                               generator=torch.Generator().manual_seed(SEED)).state_dict())
    runs = {}
    for name, sampler, dtype in (("kernel", "pallas", torch.float32),
                                 ("plain", "xla", torch.float32),
                                 ("kernel_bf16", "pallas", torch.bfloat16)):
        # "plain": the plain sampler and the plain smoothness term
        with plain_smoothness() if name == "plain" else contextlib.nullcontext():
            state, metrics = config4_step(sampler, batch)(
                config4_state(device, sd, dtype), batch)
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.detach() for k, p in state.model.named_parameters()})
        print(f"step parity {name}: " + ", ".join(f"{k} {v:.6f}"
                                                  for k, v in runs[name][0].items()))
    (lk, pk), (lp, pp), (lb, _) = runs["kernel"], runs["plain"], runs["kernel_bf16"]
    loss_err = max(abs(lk[k] - lp[k]) / abs(lp[k]) for k in lp)
    lr = 2e-4
    off = total = 0
    worst = 0.0
    for k in pp:
        diff = (pk[k] - pp[k]).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > TOL_STEP["param_atol"]).sum())
        total += diff.numel()
    bf16_err = abs(lb["total"] - lp["total"]) / abs(lp["total"])
    print(f"step parity f32, kernels vs plain sampler and smoothness: loss components rel err max "
          f"{loss_err:.2e} (tolerance {TOL_STEP['loss_rtol']:.0e}); params after Adam: max "
          f"abs diff {worst:.2e} (tolerance 2 lr = {2 * lr:.0e}), {off} of {total} "
          f"({off / total:.4%}) beyond {TOL_STEP['param_atol']:.0e} (tolerance "
          f"{TOL_STEP['param_share_off']:.0%}); bf16 step-1 total {lb['total']:.4f} vs f32 "
          f"{lp['total']:.4f}, rel {bf16_err:.2e} (tolerance {TOL_BF16_LOSS}) [{smi}]")
    if loss_err > TOL_STEP["loss_rtol"] or worst > 2 * lr * (1 + 1e-4) \
            or off / total >= TOL_STEP["param_share_off"] or bf16_err > TOL_BF16_LOSS:
        raise AssertionError("step parity beyond its tolerances")
    return {"loss_rel_err": loss_err, "param_share_off": off / total, "bf16_rel": bf16_err}


def step_calls(device) -> list:
    """The 12 sampler calls of a config-4 step: (imgs, coords, needs dcoords) per warp."""
    g = np.random.RandomState(SEED + 5)
    calls = []
    for s in range(4):
        h, w = C4_HEIGHT >> s, C4_WIDTH >> s
        imgs = torch.from_numpy((g.rand(C4_BATCH, h, w, 3) * 255).astype(np.float32))
        coords = warp_coords(C4_BATCH, h, w, device, seed=SEED + 10 + s)
        imgs = imgs.to(device)
        # GT-depth warp (no gradient), predicted-depth warp and flow warp (dcoords)
        calls += [(imgs, coords, False), (imgs, coords.clone().requires_grad_(True), True),
                  (imgs, coords.clone().requires_grad_(True), True)]
    return calls


def phase_sampler_times(device, smi: str) -> dict:
    imgs, coords = sampler_cases(device)["warp"]
    B, H, W, C = imgs.shape
    grid = torch.stack([coords[..., 0] * (2.0 / (W - 1)) - 1,
                        coords[..., 1] * (2.0 / (H - 1)) - 1], -1)
    imgs_nchw = imgs.permute(0, 3, 1, 2)
    ms = time_ms(lambda: bilinear_sample(imgs, coords), 50)
    plain = time_ms(lambda: bilinear_sample_reference(imgs, coords), 20)
    lib = time_ms(lambda: F.grid_sample(imgs_nchw, grid, mode="bilinear",
                                        padding_mode="zeros", align_corners=True), 50)
    bound, by = sample_bound(B, H, W, H, W, C)
    print(f"time bilinear_sample scale 0 B={B} {H}x{W}x{C}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, grid_sample {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"kernel/bound {ms / bound:.1f}x [{smi}]")
    calls = step_calls(device)
    ms12 = time_ms(lambda: [bilinear_sample(i, c) for i, c, _ in calls], 20)
    plain12 = time_ms(lambda: [bilinear_sample_reference(i, c) for i, c, _ in calls], 10)
    libs = [(i.permute(0, 3, 1, 2), torch.stack(
        [c[..., 0] * (2.0 / (i.shape[2] - 1)) - 1, c[..., 1] * (2.0 / (i.shape[1] - 1)) - 1],
        -1).detach()) for i, c, _ in calls]
    lib12 = time_ms(lambda: [F.grid_sample(i, g, mode="bilinear", padding_mode="zeros",
                                           align_corners=True) for i, g in libs], 20)
    bound12 = sum(sample_bound(i.shape[0], *i.shape[1:3], *c.shape[1:3], i.shape[3], g)[0]
                  for i, c, g in calls)
    print(f"time bilinear_sample, the 12 calls of a config-4 step (B={B}, scales "
          f"{C4_HEIGHT}x{C4_WIDTH}..{C4_HEIGHT >> 3}x{C4_WIDTH >> 3}, 8 with corner planes):"
          f" kernel {ms12:.4f} ms, plain {plain12:.4f} ms, grid_sample {lib12:.4f} ms, "
          f"bound {bound12:.4f} ms [{smi}]")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
            "bound_by": by, "ms12": ms12, "plain12": plain12, "lib12": lib12,
            "bound12": bound12}


def phase_training_times(device, batch: dict, smi: str) -> dict:
    """ms/step of the bf16 config-4 step with the kernel and with the plain sampler, in
    turns (plain, kernel, kernel, plain) on one state."""
    sd = DispNet(DispNetVariant.depth10_flow(),
                 generator=torch.Generator().manual_seed(SEED)).state_dict()
    state = config4_state(device, sd, torch.bfloat16)
    steps = {"kernel": config4_step("pallas", batch), "plain": config4_step("xla", batch)}
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(time_ms(lambda: steps[name](state, batch), 10))
    out = {}
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        out[name] = ms
        print(f"time training step bf16 config 4 ({C4_HEIGHT}x{C4_WIDTH}, B={C4_BATCH}) sampler={name}: "
              f"{ms:.2f} ms/step ({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{C4_BATCH / ms * 1e3:.1f} frames/s [{smi}]")
    return out


def smooth_cases(device) -> dict:
    """name -> a [B, H, W, 1] float32 map on ``device``: config 2's four scales (B=10,
    disparities in [0, 4] as the sigmoid * 4 heads give), a strided C=1 flow plane, exact
    ties and an odd size."""
    g = np.random.RandomState(SEED + 6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    cases = {f"config2 s{s}": t(g.uniform(0, 4, (C2_BATCH, C2_HEIGHT >> s, C2_WIDTH >> s, 1)))
             for s in range(4)}
    # config 4's flow heads: NCHW [B, 2, H, W] viewed NHWC, channel 1 (batch stride 2HW)
    flow = t(g.randn(C4_BATCH, 2, C4_HEIGHT, C4_WIDTH))
    cases["flow plane"] = flow.permute(0, 2, 3, 1)[..., 1:2]
    cases["constant"] = t(np.full((C2_BATCH, 60, 180, 1), 1.5))
    cases["piecewise"] = t(np.kron(g.randint(0, 4, (C2_BATCH, 10, 18, 1)) * 0.25,
                                   np.ones((1, 6, 10, 1))))
    cases["odd 37x53"] = t(g.uniform(0, 4, (C2_BATCH, 37, 53, 1)))
    return cases


def _smooth_grad(fn, x: torch.Tensor):
    """(fn(x), d fn / d x) through autograd, x a view of a leaf as the step's heads are."""
    leaf = x.detach().clone().requires_grad_(True)
    out = fn(leaf)
    (grad,) = torch.autograd.grad(out, leaf)
    return out.detach(), grad


def phase_smoothness(device, smi: str) -> dict:
    """smoothness_fused vs the plain term: forward (float32 and float64 plain), backward
    (autograd of the plain term, and the gather formula), and the same bits twice."""
    worst = {"fwd": 0.0, "bwd_rel": 0.0}
    for name, x in smooth_cases(device).items():
        got, grad = _smooth_grad(smoothness_fused, x)
        got2, grad2 = _smooth_grad(smoothness_fused, x)
        ref, ref_grad = _smooth_grad(second_order_smoothness, x)
        ref64 = second_order_smoothness(x.double())
        gather = smoothness_backward_reference(x, torch.ones((), device=device))
        torch.cuda.synchronize()
        if not (torch.equal(got, got2) and torch.equal(grad, grad2)):
            raise AssertionError(f"smoothness {name}: two runs differ")
        err, err64 = abs(got.item() - ref.item()), abs(got.item() - ref64.item())
        scale = ref_grad.abs().max().item()
        gerr = (grad - ref_grad).abs().max().item()
        gather_err = (grad - gather).abs().max().item()
        print(f"kernel smoothness {name} {tuple(x.shape)} strides {x.stride()}: forward "
              f"{got.item():.7f}, abs err {err:.3e} vs plain f32, {err64:.3e} vs plain f64 "
              f"(rtol {TOL_SMOOTH_FWD:.0e}); backward abs err max {gerr:.3e} vs autograd, "
              f"{gather_err:.3e} vs the gather formula (|g| max {scale:.3e}, tolerance "
              f"{TOL_SMOOTH_BWD:.0e} x |g| max); two runs bit-equal [{smi}]")
        if err > TOL_SMOOTH_FWD * abs(ref.item()) or err64 > TOL_SMOOTH_FWD * abs(
                ref64.item()) or gerr > TOL_SMOOTH_BWD * scale \
                or gather_err > TOL_SMOOTH_BWD * scale:
            raise AssertionError(f"smoothness {name}: beyond its tolerances")
        worst["fwd"] = max(worst["fwd"], err)
        worst["bwd_rel"] = max(worst["bwd_rel"], gerr / scale if scale else 0.0)
    return worst


def phase_depth_only(device, dataset: str, *, height: int = C2_HEIGHT,
                     width: int = C2_WIDTH, batch: int = C2_BATCH, steps: int = C2_STEPS,
                     val_check: int = C2_VAL_CHECK, dtype: str = "bfloat16",
                     smi: str = "") -> dict:
    """The config-2 CLI for ``steps`` steps with validation every ``val_check``; every
    train and val record finite; the checkpoint read back into depth4 DispNet."""
    ckpt = os.path.join(os.path.dirname(dataset), "checkpoints_depth_only")
    t0 = time.perf_counter()
    state, _ = depth_only.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size", str(batch),
        "--max_steps", str(steps), "--summary_freq", "1", "--save_latest_freq", str(steps),
        "--validation_check", str(val_check), "--image_height", str(height),
        "--image_width", str(width), "--dtype", dtype, "--device", str(device),
        "--seed", str(SEED)])
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["scope"] == "train"]
    val = [r for r in records if r["scope"] == "val"]
    finite = all(np.isfinite(r[k]) for r in train for k in ("total", "depth", "smooth")) \
        and all(np.isfinite(r[k]) for r in val for k in ("total", "si_log_rmse", "smooth"))
    if state.step != steps or len(train) != steps or len(val) != steps // val_check \
            or not finite:
        raise AssertionError(f"depth_only: step {state.step}, records {records}")
    for r in records:
        print(f"depth_only {r['scope']} step {r['step']}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items() if k not in ("step", "scope")) + f" [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = dispnet_from_variables(variables, device=device)
    x = torch.from_numpy(_frames(batch, height, width)).to(device).permute(0, 3, 1, 2).float()
    with torch.no_grad():
        outs = model(x)
    shapes = [(batch, 1, height >> s, width >> s) for s in range(4)]
    if model.variant.name != "depth4" or [tuple(o.shape) for o in outs] != shapes \
            or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"depth_only checkpoint step {meta.get('step')}: "
                             f"{model.variant.name}, {[tuple(o.shape) for o in outs]}")
    print(f"depth_only: {steps} steps of config 2 ({dtype}, {height}x{width}, batch {batch}) "
          f"and {len(val)} validations through the CLI in {seconds:.1f} s host clock; every "
          f"record finite; model-{steps}.npz read back into DispNet(depth4), eval forward "
          f"finite [{smi}]")
    return {"steps": steps, "validations": len(val), "seconds": seconds}


def smooth_bound(pixels: int, backward: bool) -> tuple:
    """Least time (ms) an H100 SXM needs for smoothness calls over ``pixels`` pixels in
    all: the map read once (and for the backward the gradient written once), and ~18
    float32 operations a pixel forward (6 first and 4 second differences, 4 abs, 4 adds)
    or ~35 backward (the 4 terms' signs, their weighted gather and the scaling)."""
    nbytes = 4 * pixels * (2 if backward else 1)
    t_bytes, t_ops = nbytes / PEAK_HBM, pixels * (35 if backward else 18) / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def step_smooth_calls(config: str, device) -> list:
    """The maps of a step's smoothness calls, as the step's heads reach the loss: config
    2's 4 depth heads (NCHW [B,1,H,W] viewed NHWC); config 4's depth heads and both
    channels of its flow heads ([B,2,H,W] viewed NHWC), at each of 4 scales."""
    g = np.random.RandomState(SEED + 7)
    B = C2_BATCH if config == "depth_only" else C4_BATCH
    H, W = (C2_HEIGHT, C2_WIDTH) if config == "depth_only" else (C4_HEIGHT, C4_WIDTH)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    calls = []
    for s in range(4):
        h, w = H >> s, W >> s
        calls.append(t(g.uniform(0, 4, (B, 1, h, w))).permute(0, 2, 3, 1))
        if config == "optflow_combine":
            flow = t(g.randn(B, 2, h, w)).permute(0, 2, 3, 1)
            calls += [flow[..., 0:1], flow[..., 1:2]]
    return calls


def _time_smooth(calls: list) -> dict:
    """ms of the forward alone and of the forward and backward, kernels and plain term,
    over ``calls`` (their sum, as the loss takes it)."""
    leaves = [c.detach().clone().requires_grad_(True) for c in calls]
    out = {}
    for name, fn in (("kernel", smoothness_fused), ("plain", second_order_smoothness)):
        iters = 50 if name == "kernel" else 20
        with torch.no_grad():
            out[f"{name}_fwd"] = time_ms(lambda: [fn(c) for c in calls], iters)
        out[f"{name}_fwdbwd"] = time_ms(lambda: torch.autograd.grad(
            sum(fn(c) for c in leaves), leaves), iters)
    return out


def phase_smooth_times(device, smi: str) -> dict:
    """The kernels against the plain term, forward and backward, at config 2's scale 0
    (the backward alone too) and over a step's calls in configs 2 and 4."""
    x = step_smooth_calls("depth_only", device)[0]
    px = x.shape[0] * x.shape[1] * x.shape[2]
    row = _time_smooth([x])
    leaf = x.detach().clone().requires_grad_(True)
    for name, fn in (("kernel", smoothness_fused), ("plain", second_order_smoothness)):
        out = fn(leaf)   # the backward alone, through autograd as the step runs it
        row[f"{name}_bwd"] = time_ms(lambda: torch.autograd.grad(out, leaf,
                                                                 retain_graph=True), 20)
    bf, by = smooth_bound(px, False)
    bb, _ = smooth_bound(px, True)
    row.update(bound_fwd=bf, bound_bwd=bb, bound_by=by)
    print(f"time smoothness config 2 scale 0 {tuple(x.shape)}: forward kernel "
          f"{row['kernel_fwd']:.4f} ms, plain {row['plain_fwd']:.4f} ms, bound {bf:.4f} ms "
          f"({by}); backward kernel {row['kernel_bwd']:.4f} ms, plain (autograd) "
          f"{row['plain_bwd']:.4f} ms, bound {bb:.4f} ms; forward+backward kernel "
          f"{row['kernel_fwdbwd']:.4f} ms, plain {row['plain_fwdbwd']:.4f} ms [{smi}]")
    for config in ("depth_only", "optflow_combine"):
        calls = step_smooth_calls(config, device)
        px = sum(c.shape[0] * c.shape[1] * c.shape[2] for c in calls)
        r = _time_smooth(calls)
        bf, _ = smooth_bound(px, False)
        bb, _ = smooth_bound(px, True)
        row[config] = {**r, "bound_fwd": bf, "bound_bwd": bb}
        print(f"time smoothness, the {len(calls)} calls of a {config} step ({px} pixels): "
              f"forward kernel {r['kernel_fwd']:.4f} ms, plain {r['plain_fwd']:.4f} ms, bound "
              f"{bf:.4f} ms; forward+backward kernel {r['kernel_fwdbwd']:.4f} ms, plain "
              f"{r['plain_fwdbwd']:.4f} ms, bound {bf + bb:.4f} ms [{smi}]")
    return row


def phase_depth_only_times(device, smi: str) -> dict:
    """ms/step of the bf16 config-2 step with the smoothness kernels and with the plain
    term, in turns (plain, kernel, kernel, plain) on one state and batch."""
    from tf_depth_estimation_torch.train.profile_step import pair_batch

    batch = pair_batch(C2_BATCH, C2_HEIGHT, C2_WIDTH, SEED, device)
    model = DispNet(DispNetVariant.depth4(), generator=torch.Generator().manual_seed(SEED),
                    dtype=torch.bfloat16).to(device)
    state = create_train_state(model)
    step = make_depth_only_step(dataclasses.replace(
        LossWeights.depth_only(), height=C2_HEIGHT, width=C2_WIDTH))
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        with plain_smoothness() if name == "plain" else contextlib.nullcontext():
            times[name].append(time_ms(lambda: step(state, batch), 10))
    out = {}
    for name, ts in times.items():
        out[name] = sum(ts) / len(ts)
        print(f"time training step bf16 config 2 ({C2_HEIGHT}x{C2_WIDTH}, B={C2_BATCH}) "
              f"smoothness={name}: {out[name]:.2f} ms/step (turns "
              f"{', '.join(f'{t:.2f}' for t in ts)}; spread {max(ts) - min(ts):.2f} ms), "
              f"{C2_BATCH / out[name] * 1e3:.1f} frames/s [{smi}]")
    return out


def sig_cases(device) -> dict:
    """name -> (pred base, view, gt, deltas): ``view(base)`` is the [B, H, W, 1] prediction.
    Phase 2's four scales (B=1, delta 2), the 5-delta full_scales call at 192x256 (B=1 and
    8), a coarse map that the longer deltas overreach, an odd size, and channel 1 of an
    NCHW [B, 2, H, W] head viewed NHWC. Values as the heads and labels give: disparities in
    (0, 4], inverse depths of 0.4 to 2.5 m."""
    g = np.random.RandomState(SEED + 8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    same = lambda x: x
    cases = {}

    def add(name, B, H, W, deltas):
        cases[name] = (t(g.uniform(0.05, 4, (B, H, W, 1))), same,
                       t(1 / g.uniform(0.4, 2.5, (B, H, W, 1))), deltas)

    for s in range(4):
        add(f"phase2 s{s}", ST_BATCH, ST_HEIGHT >> s, ST_WIDTH >> s, (2,))
    add("full_scales B=1", 1, ST_HEIGHT, ST_WIDTH, FULL_SCALE_DELTAS)
    add("full_scales B=8", 8, ST_HEIGHT, ST_WIDTH, FULL_SCALE_DELTAS)
    add("coarse 12x16", 2, 12, 16, FULL_SCALE_DELTAS)   # d = 16 >= H and >= W
    add("odd 37x53", 2, 37, 53, FULL_SCALE_DELTAS)
    head = t(g.uniform(0.05, 4, (2, 2, 48, 64)))
    cases["strided plane"] = (head, lambda x: x.permute(0, 2, 3, 1)[..., 1:2],
                              t(1 / g.uniform(0.4, 2.5, (2, 48, 64, 1))), (2,))
    return cases


def _sig_grad(fn, base, view, gt, deltas):
    """(fn(view(base), gt), d/d view(base), d/d gt) through autograd, the prediction a
    view of a leaf as the step's heads are."""
    leaf, gleaf = base.detach().clone().requires_grad_(True), gt.detach().clone().requires_grad_(True)
    out = fn(view(leaf), gleaf, deltas)
    dbase, dgt = torch.autograd.grad(out, [leaf, gleaf])
    return out.detach(), view(dbase), dgt


def phase_sig(device, smi: str) -> dict:
    """sig_l2_fused vs the plain composition: forward (float32 and float64 plain),
    backward for pred and gt (autograd of the plain version, and the gather formula), and
    the same bits twice."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, (base, view, gt, deltas) in sig_cases(device).items():
        got, dp, dg = _sig_grad(sig_l2_fused, base, view, gt, deltas)
        got2, dp2, dg2 = _sig_grad(sig_l2_fused, base, view, gt, deltas)
        ref, rp, rg = _sig_grad(sig_l2_plain, base, view, gt, deltas)
        x = view(base)
        ref64 = sig_l2_plain(x.double(), gt.double(), deltas)
        gp, gg = sig_l2_backward_reference(x, gt, torch.ones((), device=device), deltas)
        torch.cuda.synchronize()
        if not (torch.equal(got, got2) and torch.equal(dp, dp2) and torch.equal(dg, dg2)):
            raise AssertionError(f"sig {name}: two runs differ")
        err, err64 = abs(got.item() - ref.item()), abs(got.item() - ref64.item())
        # each gradient (d pred, d gt) within TOL_SIG_BWD of its own max|g|
        gerrs = [((a - r).abs().max().item(), TOL_SIG_BWD * r.abs().max().item())
                 for a, r in ((dp, rp), (dg, rg))]
        (ep, tp), (eg, tg) = gerrs
        gather_equal = torch.equal(dp, gp) and torch.equal(dg, gg)
        print(f"kernel sig_l2 {name} {tuple(x.shape)} strides {x.stride()} deltas {deltas}: "
              f"forward {got.item():.7f}, abs err {err:.3e} vs plain f32, {err64:.3e} vs "
              f"plain f64 (rtol {TOL_SIG_FWD:.0e}); backward abs err vs autograd {ep:.3e} "
              f"d pred (limit {tp:.3e}), {eg:.3e} d gt (limit {tg:.3e}), limits "
              f"{TOL_SIG_BWD:.0e} of max|g|; bit-equal to the gather formula: "
              f"{gather_equal}; two runs bit-equal [{smi}]")
        if err > TOL_SIG_FWD * abs(ref.item()) or err64 > TOL_SIG_FWD * abs(ref64.item()) \
                or any(e > t for e, t in gerrs) or not gather_equal:
            raise AssertionError(f"sig {name}: beyond its tolerances")
        worst["fwd"] = max(worst["fwd"], err)
        worst["bwd"] = max(worst["bwd"], ep, eg)
    return worst


def demon_batches(batch: int, height: int, width: int, device, seed: int = SEED):
    """An endless stream of DeMoN batches of synthetic scenes (``demon_batch``)."""
    rng = np.random.RandomState(seed)
    while True:
        yield demon_batch(batch, height, width, rng, device)


def _records(directory: str, comps) -> list:
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if not all(np.isfinite(r[k]) for r in records for k in comps):
        raise AssertionError(f"non-finite loss in {directory}: {records}")
    return records


def phase_split_training(device, root: str, *, height: int = ST_HEIGHT,
                         width: int = ST_WIDTH, batch: int = ST_BATCH,
                         steps: int = ST_STEPS, dtype: str = "bfloat16",
                         smi: str = "") -> dict:
    """split_training's two phases for ``steps`` steps each through the CLI's
    ``train_pair`` and ``train_single``, with the launch counts set to 0 before each phase
    and read after it; every loss component finite; both checkpoint groups read back
    into DepthPoseNet and a 4-channel DispNet with finite eval forwards."""
    pair_dir, single_dir = os.path.join(root, "pair"), os.path.join(root, "single")
    args = split_training.parse_args([
        "--checkpoint_dir", pair_dir, "--checkpoint_dir_single", single_dir,
        "--image_height", str(height), "--image_width", str(width),
        "--batch_size", str(batch), "--max_steps", str(steps),
        "--max_steps_single", str(steps), "--summary_freq", "1",
        "--save_latest_freq", str(steps), "--dtype", dtype, "--device", str(device),
        "--seed", str(SEED)])
    w = split_training.loss_weights(args)
    out = {}
    t0 = time.perf_counter()
    reset_counts()  # a main path: phase 1
    pair = split_training.train_pair(args, w, split_training.pair_state(args),
                                     demon_batches(batch, height, width, device))
    out["pair"] = read_counts()
    reset_counts()  # a main path: phase 2
    single = split_training.train_single(args, w, pair,
                                         demon_batches(batch, height, width, device,
                                                       seed=SEED + 1))
    out["single"] = read_counts()
    out["seconds"] = time.perf_counter() - t0
    recs = {"pair": _records(pair_dir, ("total", "depth", "cam", "consist", "sig", "exp")),
            "single": _records(single_dir, ("total", "depth", "sig"))}
    if pair.step != steps or single.step != steps or any(len(r) != steps
                                                         for r in recs.values()):
        raise AssertionError(f"split_training: steps {pair.step}, {single.step}, "
                             f"records {recs}")
    for phase, records in recs.items():
        for r in records:
            print(f"split_training {phase} step {r['step']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r.items()
                if k not in ("step", "scope", "steps_per_sec", "frames_per_sec")) + f" [{smi}]")
    x = next(demon_batches(batch, height, width, device, seed=SEED + 2))
    pv, _ = load_variables_npz(os.path.join(pair_dir, f"{split_training.PAIR_GROUP}-{steps}.npz"))
    sv, _ = load_variables_npz(os.path.join(single_dir,
                                            f"{split_training.SINGLE_GROUP}-{steps}.npz"))
    pair_model = depth_pose_from_variables(pv, device=device)
    single_model = dispnet_from_variables(sv, device=device)
    with torch.no_grad():
        disps, pose, masks = pair_model(x["image_pair"].permute(0, 3, 1, 2))
        inp = next(split_training.single_batches(pair_model, iter([x])))["input"]
        depths = single_model(inp.permute(0, 3, 1, 2))
    shapes = [(batch, 1, height >> s, width >> s) for s in (2, 3)]
    outs = [*disps, pose, *masks, *depths]
    if pair_model.full_resolution or [tuple(d.shape) for d in disps] != shapes \
            or single_model.encoder["cnv1"].conv.weight.shape[1] != 4 or len(depths) != 4 \
            or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"split_training checkpoints: {[tuple(o.shape) for o in outs]}")
    print(f"split_training: {steps} steps of phase 1 and {steps} of phase 2 ({dtype}, "
          f"{height}x{width}, batch {batch}) in {out['seconds']:.1f} s host clock; every loss "
          f"component finite; {split_training.PAIR_GROUP}-{steps}.npz read back into "
          f"DepthPoseNet and {split_training.SINGLE_GROUP}-{steps}.npz into a 4-channel "
          f"DispNet(depth4), eval forwards finite [{smi}]")
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def _parity_run(phase: str, sd: dict, batch: dict, device, dtype, plain: bool):
    """One step of ``phase`` from the state dict ``sd`` at step PARITY_STEP; (metrics,
    parameters after the step)."""
    w = dataclasses.replace(LossWeights.split_training(), height=ST_HEIGHT, width=ST_WIDTH)
    if phase == "pair":
        model = DepthPoseNet(dtype=dtype)
        state = create_train_state(model, lr_schedule=exponential_decay(2e-4, 10000, 0.96))
        step = make_pairwise_step(w)
    else:
        model = DispNet(DispNetVariant.depth4(), in_channels=4, dtype=dtype)
        state = create_train_state(model)
        step = make_single_depth_step(w)
    model.load_state_dict(sd)
    model.to(device)
    state.step = PARITY_STEP
    with plain_sig() if plain else contextlib.nullcontext():
        state, metrics = step(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach() for k, p in state.model.named_parameters()})


def phase_split_parity(device, smi: str) -> dict:
    """One f32 step of each phase with the sig kernel vs one with the plain composition,
    from one init and batch at step PARITY_STEP; the bf16 step's loss against the f32 one."""
    x = next(demon_batches(ST_BATCH, ST_HEIGHT, ST_WIDTH, device, seed=SEED + 3))
    pair_sd = copy.deepcopy(DepthPoseNet(
        generator=torch.Generator().manual_seed(SEED)).state_dict())
    coarse_net = DepthPoseNet().to(device)
    coarse_net.load_state_dict(pair_sd)
    batches = {"pair": x,
               "single": next(split_training.single_batches(coarse_net, iter([x])))}
    sds = {"pair": pair_sd, "single": copy.deepcopy(DispNet(
        DispNetVariant.depth4(), in_channels=4,
        generator=torch.Generator().manual_seed(SEED)).state_dict())}
    out, lr = {}, 2e-4
    for phase in ("pair", "single"):
        (lk, pk), (lp, pp), (lb, _) = (
            _parity_run(phase, sds[phase], batches[phase], device, dt, plain)
            for dt, plain in ((torch.float32, False), (torch.float32, True),
                              (torch.bfloat16, False)))
        loss_err = max(_rel(lk[k], lp[k]) for k in lp)
        off = total = 0
        worst = 0.0
        for k in pp:
            diff = (pk[k] - pp[k]).abs()
            worst = max(worst, diff.max().item())
            off += int((diff > TOL_STEP["param_atol"]).sum())
            total += diff.numel()
        bf16_err = _rel(lb["total"], lp["total"])
        print(f"step parity f32 split_training {phase} at step {PARITY_STEP}, sig kernel vs "
              f"plain: " + ", ".join(f"{k} {lk[k]:.6f}/{lp[k]:.6f}" for k in lp)
              + f"; loss components rel err max {loss_err:.2e} (tolerance "
              f"{TOL_STEP['loss_rtol']:.0e}); params after Adam: max abs diff {worst:.2e} "
              f"(tolerance 2 lr = {2 * lr:.0e}), {off} of {total} ({off / total:.4%}) "
              f"beyond {TOL_STEP['param_atol']:.0e} (tolerance "
              f"{TOL_STEP['param_share_off']:.0%}); bf16 total {lb['total']:.4f} vs f32 "
              f"{lp['total']:.4f}, rel {bf16_err:.2e} (tolerance {TOL_BF16_LOSS}) [{smi}]")
        if loss_err > TOL_STEP["loss_rtol"] or worst > 2 * lr * (1 + 1e-4) \
                or off / total >= TOL_STEP["param_share_off"] or bf16_err > TOL_BF16_LOSS:
            raise AssertionError(f"split_training {phase} step parity beyond its tolerances")
        out[phase] = {"loss_rel_err": loss_err, "param_share_off": off / total,
                      "bf16_rel": bf16_err}
    return out


def sig_bound(calls: list, backward: bool) -> tuple:
    """Least time (ms) an H100 SXM needs for sig calls ``[(pred, gt, deltas), ...]``:
    pred and gt read once (8 B a pixel) forward; pred and gt read and d pred written
    (12 B a pixel) backward, the label taking no gradient. Operations: ~15 float32 a term
    forward (per map a difference, two abs, two adds and a quotient, then the difference,
    its square and the sum) and ~24 backward (the term's two quotients once, its scale and
    the derivatives at both of its ends for d pred), plus ~2 a pixel (eps and the root,
    or the cotangent quotient), counting the terms that lie inside the map."""
    pixels = terms = 0
    for pred, _, deltas in calls:
        B, H, W, _ = pred.shape
        pixels += B * H * W
        terms += sum(B * (H * max(W - d, 0) + max(H - d, 0) * W) for d in deltas)
    nbytes = pixels * (12 if backward else 8)
    ops = terms * (24 if backward else 15) + 2 * pixels
    t_bytes, t_ops = nbytes / PEAK_HBM, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _time_sig(calls: list) -> dict:
    """ms of the forward alone and of the forward and backward (d pred, as the loss
    needs), kernel and plain composition, over ``calls`` (their sum, as the loss takes
    it)."""
    leaves = [p.detach().clone().requires_grad_(True) for p, _, _ in calls]
    out = {}
    for name, fn in (("kernel", sig_l2_fused), ("plain", sig_l2_plain)):
        iters = 50 if name == "kernel" else 20
        with torch.no_grad():
            out[f"{name}_fwd"] = time_ms(lambda: [fn(p, g, d) for p, g, d in calls], iters)
        out[f"{name}_fwdbwd"] = time_ms(lambda: torch.autograd.grad(
            sum(fn(p, g, d) for p, (_, g, d) in zip(leaves, calls)), leaves), iters)
    return out


def phase_sig_times(device, smi: str) -> dict:
    """The sig kernels against the plain composition at phase 2's four step calls (the
    main path's shapes) and at the 5-delta 192x256 B=8 call."""
    cases = sig_cases(device)
    rows = {}
    for label, names in (("phase-2 step, 4 calls", [f"phase2 s{s}" for s in range(4)]),
                         ("5-delta 192x256 B=8", ["full_scales B=8"])):
        calls = [(cases[n][0], cases[n][2], cases[n][3]) for n in names]
        r = _time_sig(calls)
        bf, by = sig_bound(calls, False)
        bb, by_bwd = sig_bound(calls, True)
        # forward+backward: the larger part names what bounds the pair
        r.update(bound_fwd=bf, bound_bwd=bb, bound_by=by_bwd if bb >= bf else by)
        rows[label] = r
        print(f"time sig_l2, {label}: forward kernel {r['kernel_fwd']:.4f} ms, plain "
              f"{r['plain_fwd']:.4f} ms, bound {bf:.5f} ms ({by}); forward+backward kernel "
              f"{r['kernel_fwdbwd']:.4f} ms, plain {r['plain_fwdbwd']:.4f} ms, bound "
              f"{bf + bb:.5f} ms ({r['bound_by']}) [{smi}]")
    return rows


def phase_split_times(device, smi: str) -> dict:
    """ms/step of each phase's bf16 step with the sig kernel and with the plain
    composition, in turns (plain, kernel, kernel, plain) on one state and batch; then
    the launches a step of each from ``profile_step``."""
    out = {}
    for config in ("split_pair", "split_single"):
        _, state, step, batch = profile_step.CONFIGS[config](None, None, None, device, "xla")
        times = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            with plain_sig() if name == "plain" else contextlib.nullcontext():
                times[name].append(time_ms(lambda: step(state, batch), 5))
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            out[(config, name)] = {"ms": ms}
            print(f"time training step bf16 {config} ({ST_HEIGHT}x{ST_WIDTH}, B={ST_BATCH}) "
                  f"sig={name}: {ms:.2f} ms/step (turns {', '.join(f'{t:.2f}' for t in ts)})"
                  f" [{smi}]")
    for config in ("split_pair", "split_single"):
        for name in ("kernel", "plain"):
            prof = profile_step.profile(steps=1, device=device, config=config, sig=name,
                                        top=0)
            out[(config, name)].update(launches=prof["launches"],
                                       kernel_ms=prof["kernel_ms"])
    return out


def reset_counts() -> None:
    fused_tail.launches = bilinear_sample.launches = 0
    smoothness_fused.launches = smoothness_fused.backward_launches = 0
    sig_l2_fused.launches = sig_l2_fused.backward_launches = 0


def read_counts() -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"fused_tail": fused_tail.launches, "bilinear_sample": bilinear_sample.launches,
            "smoothness_fwd": smoothness_fused.launches,
            "smoothness_bwd": smoothness_fused.backward_launches,
            "sig_fwd": sig_l2_fused.launches, "sig_bwd": sig_l2_fused.backward_launches}


def main() -> None:
    t_start = time.perf_counter()

    def stamp(label: str) -> None:
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s after {label}")

    info = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    stamp("build")
    variables, meta = load_variables_npz(TEACHER)
    print(f"weights: {os.path.relpath(TEACHER, ROOT)} {meta}")
    folded = {dt: fold_weights(variables, dtype=dt, device="cuda")
              for dt in (torch.float32, torch.bfloat16)}
    errs = phase_kernel(folded)
    fwd = phase_forward(variables, "cuda")
    if fwd["launches"] < 1:
        raise AssertionError("the f32 forward did not launch fused_tail")

    reset_counts()  # a main path: serving
    phase_serving(variables, "cuda")
    serving = read_counts()
    print(f"serving launches: {serving}")
    if serving["fused_tail"] < 1:
        raise AssertionError("serving did not launch fused_tail")
    stamp("serving")

    rows = phase_times(folded, info["smi"])
    stamp("serving times")
    main_row = rows[(8, torch.bfloat16)]  # the serving path's shapes and dtype
    sample_errs = phase_sampler("cuda", info["smi"])
    smooth_errs = phase_smoothness("cuda", info["smi"])
    sig_errs = phase_sig("cuda", info["smi"])
    stamp("kernel checks")

    with tempfile.TemporaryDirectory() as tmp:
        dataset = write_dataset(tmp)
        reset_counts()  # a main path: config-4 training
        phase_training("cuda", dataset, smi=info["smi"])
        training = read_counts()
        print(f"training launches: {training} in {C4_STEPS} steps [{info['smi']}]")
        n_fwd, n_bwd = SMOOTH_PER_STEP["optflow_combine"]
        if training["bilinear_sample"] != LAUNCHES_PER_STEP * C4_STEPS \
                or training["smoothness_fwd"] != n_fwd * C4_STEPS \
                or training["smoothness_bwd"] != n_bwd * C4_STEPS:
            raise AssertionError(f"config-4 training launched {training} in {C4_STEPS} "
                                 f"steps, not {LAUNCHES_PER_STEP} bilinear_sample and "
                                 f"{n_fwd} + {n_bwd} smoothness a step")
        batch = first_batch(dataset, "cuda")
        stamp("config-4 training")

        reset_counts()  # a main path: config-2 training with validation
        c2 = phase_depth_only("cuda", dataset, smi=info["smi"])
        depth_counts = read_counts()
        print(f"depth_only launches: {depth_counts} in {C2_STEPS} steps and "
              f"{c2['validations']} validations [{info['smi']}]")
        n_fwd, n_bwd = SMOOTH_PER_STEP["depth_only"]
        want = (n_fwd * C2_STEPS + SMOOTH_PER_VAL * c2["validations"], n_bwd * C2_STEPS)
        if (depth_counts["smoothness_fwd"], depth_counts["smoothness_bwd"]) != want:
            raise AssertionError(f"config-2 training launched smoothness {depth_counts}, "
                                 f"not {want} (forward, backward)")
        stamp("config-2 training")

        # two main paths: split_training's phases, each between its own count resets
        split = phase_split_training("cuda", os.path.join(tmp, "split"), smi=info["smi"])
        for phase, (n_fwd, n_bwd) in SIG_PER_STEP.items():
            got = split[phase]
            print(f"split_training {phase} launches: {got} in {ST_STEPS} steps "
                  f"[{info['smi']}]")
            if (got["sig_fwd"], got["sig_bwd"]) != (n_fwd * ST_STEPS, n_bwd * ST_STEPS):
                raise AssertionError(f"split_training {phase} launched sig {got}, not "
                                     f"{n_fwd} + {n_bwd} a step")
        stamp("split_training")
    phase_step_parity("cuda", batch, info["smi"])
    stamp("config-4 step parity")
    srow = phase_sampler_times("cuda", info["smi"])
    phase_training_times("cuda", batch, info["smi"])
    stamp("config-4 times")
    mrow = phase_smooth_times("cuda", info["smi"])
    phase_depth_only_times("cuda", info["smi"])
    stamp("smoothness and config-2 times")
    phase_split_parity("cuda", info["smi"])
    stamp("split_training step parity")
    sig_row = phase_sig_times("cuda", info["smi"])["phase-2 step, 4 calls"]
    phase_split_times("cuda", info["smi"])
    stamp("sig and split_training times")

    kernels = [{
        "name": "fused_tail", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/fused_tail.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_tail.py:112",
        "launches": serving["fused_tail"], "max_abs_err": errs[torch.bfloat16],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
    }, {
        "name": "bilinear_sample", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/bilinear_sample.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_sample.py:97",
        "launches": training["bilinear_sample"], "max_abs_err": sample_errs["out"],
        "ms": srow["ms"], "plain_ms": srow["plain_ms"], "bound_ms": srow["bound_ms"],
        "bound_by": srow["bound_by"],
        # grid_sample(bilinear, zeros, align_corners=True): the closest library call, not
        # the same function (normalised coordinates, no wmask)
        "library_ms": srow["library_ms"],
    }, {
        # forward and backward of one call at config 2's scale 0 (B=10, 240x720);
        # launches: forward + backward calls in the config-2 run
        "name": "smoothness", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/smoothness.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_losses.py:140",
        "launches": depth_counts["smoothness_fwd"] + depth_counts["smoothness_bwd"],
        "max_abs_err": smooth_errs["fwd"],
        "ms": mrow["kernel_fwdbwd"], "plain_ms": mrow["plain_fwdbwd"],
        "bound_ms": mrow["bound_fwd"] + mrow["bound_bwd"], "bound_by": mrow["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
    }, {
        # forward and backward of phase 2's four calls a step (B=1, 192x256 down to 24x32,
        # delta 2); launches: forward + backward calls in both phases' runs
        "name": "sig_l2", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/sig_l2.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_losses.py:63",
        "launches": sum(split[p]["sig_fwd"] + split[p]["sig_bwd"] for p in SIG_PER_STEP),
        "max_abs_err": sig_errs["fwd"],
        "ms": sig_row["kernel_fwdbwd"], "plain_ms": sig_row["plain_fwdbwd"],
        "bound_ms": sig_row["bound_fwd"] + sig_row["bound_bwd"],
        "bound_by": sig_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
    }]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {info['smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}))


if __name__ == "__main__":
    main()
