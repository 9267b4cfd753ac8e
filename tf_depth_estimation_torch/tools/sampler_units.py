"""The sampler's units of work on the card: the warps of one training step, timed each way
the package offers, forward and forward + backward, beside the bound.

    python tf_depth_estimation_torch/tools/sampler_units.py [--root DIR]

The units are the warps as the loss pipelines make them:

* ``config 4``: the 12 warps of a config-4 step (B=10, C=3, 224x480 down to 28x60): at each
  scale a GT-depth warp (no gradient), a predicted-depth warp and a flow warp (dcoords),
  all three of the scale's one image (``losses/pipelines.py:optflow_combine_loss``);
* ``config 3``: the 4 Euler warps of a config-3 step (B=16, C=3, 192x256 down to 24x32),
  each with dcoords (``depth_then_cam_loss``).

The ways: ``group``, one call of the group wrapper, where the package has one
(``bilinear_sample_group``, ``bilinear_sample_fused_group``); ``calls``, the single-call
wrapper once a warp (``bilinear_sample``, ``bilinear_sample_fused``), which is how the
pipelines called the kernels before the groups; ``plain``, ``bilinear_sample_reference``
once a warp; ``grid_sample``, the closest library call (normalised coordinates, no wmask),
a yardstick the package never calls. Each way is timed with CUDA events, forward (no
autograd) and forward + backward (the outputs of the warps with dcoords to their coords,
at seeded cotangents), in turns (the ways in order, then reversed; the host's speed drifts
within a run); then one forward + backward under ``torch.profiler``, after a warm-up one,
for its device time and kernel launches. ``--root`` imports the package from another checkout (built
there), so that two commits can be timed in turns in one run; run this file as a
script for that. No CPU path: without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

PEAK_F32, PEAK_HBM = 67e12, 3.35e12  # H100 SXM (NVIDIA data sheet, at 700 W)
SEED = 0
TURNS = 2  # each way timed in turns: the ways in order, then reversed


def _mod(name: str):
    return importlib.import_module(f"tf_depth_estimation_torch.{name}")


def time_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """ms a call of ``fn``: CUDA events around ``iters`` calls after ``warmup``."""
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


def _depth_warp_coords(B: int, H: int, W: int, device, seed: int, fmt: str) -> torch.Tensor:
    """A real warp's coords: seeded depth in [0.8, 2.5], a translation of up to 5 cm and a
    rotation of up to 0.02 rad; ``fmt`` "matrix" (config 4's intrinsics) or "euler"
    (config 3's)."""
    warp = _mod("geometry.warp")
    g = np.random.RandomState(seed)
    depth = torch.from_numpy(g.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    if fmt == "euler":
        pose = torch.from_numpy(np.concatenate([g.uniform(-0.05, 0.05, (B, 3)),
                                                g.uniform(-0.02, 0.02, (B, 3))], -1)
                                .astype(np.float32))
        K = torch.tensor([[0.89 * W, 0.0, W / 2], [0.0, 1.19 * H, H / 2], [0.0, 0.0, 1.0]])
    else:
        pose = torch.eye(4).repeat(B, 1, 1)
        a = torch.from_numpy(g.uniform(-0.02, 0.02, B).astype(np.float32))
        pose[:, 0, 0], pose[:, 0, 1] = a.cos(), -a.sin()
        pose[:, 1, 0], pose[:, 1, 1] = a.sin(), a.cos()
        pose[:, :3, 3] = torch.from_numpy(g.uniform(-0.05, 0.05, (B, 3)).astype(np.float32))
        K = torch.tensor([[0.9 * W, 0.0, W / 2], [0.0, 0.9 * W, H / 2], [0.0, 0.0, 1.0]])
    img = torch.zeros((B, H, W, 1), device=device)
    return warp.projective_inverse_warp(img, depth.to(device), pose.to(device),
                                        K.expand(B, 3, 3).contiguous().to(device),
                                        fmt=fmt).coords.contiguous()


def units(device) -> Dict[str, List[tuple]]:
    """unit -> its warps as (imgs [B,Hs,Ws,3] in [0, 255], coords, needs dcoords)."""
    g = np.random.RandomState(SEED)
    img = lambda B, h, w: torch.from_numpy((g.rand(B, h, w, 3) * 255).astype(np.float32)
                                           ).to(device)
    c4 = []
    for s in range(4):
        h, w = 224 >> s, 480 >> s
        imgs = img(10, h, w)
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        flow = np.stack([gx, gy], -1)[None] + g.randn(10, h, w, 2) * 2.0
        c4 += [(imgs, _depth_warp_coords(10, h, w, device, SEED + 10 + s, "matrix"), False),
               (imgs, _depth_warp_coords(10, h, w, device, SEED + 20 + s, "matrix"), True),
               (imgs, torch.from_numpy(flow.astype(np.float32)).to(device), True)]
    c3 = [(img(16, 192 >> s, 256 >> s),
           _depth_warp_coords(16, 192 >> s, 256 >> s, device, SEED + 30 + s, "euler"), True)
          for s in range(4)]
    return {"config 4": c4, "config 3": c3}


def unit_bound(warps: List[tuple], backward: bool) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 SXM needs for a unit. Each
    distinct image read once; the forward reads every warp's coords and writes its out and
    wmask, ~(19 + 7 C) operations a target pixel; the backward, of the warps with dcoords,
    reads their coords and out's cotangent and writes dcoords, ~(39 + 8 C) operations."""
    nbytes = ops = 0
    seen = set()
    for imgs, coords, grad in warps:
        if backward and not grad:
            continue
        B, Hs, Ws, C = imgs.shape
        n = coords.shape[0] * coords.shape[1] * coords.shape[2]
        if imgs.data_ptr() not in seen:
            seen.add(imgs.data_ptr())
            nbytes += 4 * B * Hs * Ws * C
        nbytes += 4 * (2 * n + C * n + (2 * n if backward else n))
        ops += ((39 + 8 * C) if backward else (19 + 7 * C)) * n
    t_bytes, t_ops = nbytes / PEAK_HBM, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ways(unit: str) -> Dict[str, Callable]:
    """way -> fn(imgs list, coords list) -> the outputs (a list), for the package imported."""
    bs, bsf = _mod("ops.bilinear_sample"), _mod("ops.bilinear_sample_fused")
    single = bs.bilinear_sample if unit == "config 4" else bsf.bilinear_sample_fused
    group = getattr(bs, "bilinear_sample_group", None) if unit == "config 4" else \
        getattr(bsf, "bilinear_sample_fused_group", None)
    out = {}
    if group is not None:
        out["group"] = lambda I, Cs: group(I, Cs)[0]
    out["calls"] = lambda I, Cs: [single(i, c)[0] for i, c in zip(I, Cs)]
    out["plain"] = lambda I, Cs: [bs.bilinear_sample_reference(i, c)[0]
                                  for i, c in zip(I, Cs)]

    def grid_sample(I, Cs):
        return [F.grid_sample(i.permute(0, 3, 1, 2), torch.stack(
            [c[..., 0] * (2.0 / (i.shape[2] - 1)) - 1, c[..., 1] * (2.0 / (i.shape[1] - 1)) - 1],
            -1), mode="bilinear", padding_mode="zeros", align_corners=True)
            for i, c in zip(I, Cs)]

    out["grid_sample"] = grid_sample
    return out


def time_unit(warps: List[tuple], fns: Dict[str, Callable]) -> dict:
    """``<way>_fwd`` and ``<way>_fwdbwd`` (ms, the mean of the turns; ``..._turns`` each),
    ``<way>_device_ms`` and ``<way>_kernels`` (device time and kernel launches of one
    forward + backward under ``torch.profiler``), and the bound."""
    imgs = [w[0] for w in warps]
    coords = [w[1] for w in warps]
    leaves = [c.clone().requires_grad_(True) if grad else c for _, c, grad in warps]
    grads = [k for k, w in enumerate(warps) if w[2]]
    g = np.random.RandomState(SEED + 1)
    douts = {k: torch.from_numpy(g.randn(*coords[k].shape[:3], imgs[k].shape[3])
                                 .astype(np.float32)).to(imgs[k].device) for k in grads}
    out: Dict[str, object] = {}

    def both(name):
        fn = fns[name]
        outs = fn(imgs, leaves)
        # grid_sample's output is NCHW: its cotangent the same numbers in its layout
        cot = [douts[k] if name != "grid_sample" else douts[k].permute(0, 3, 1, 2)
               for k in grads]
        return torch.autograd.grad([outs[k] for k in grads], [leaves[k] for k in grads], cot)

    order = list(fns)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for t in range(TURNS):
        for name in (order if t % 2 == 0 else order[::-1]):
            iters = 5 if name == "plain" else 20
            with torch.no_grad():
                fwd = time_ms(lambda: fns[name](imgs, coords), iters)
            fb = time_ms(lambda: both(name), iters)
            out.setdefault(f"{name}_fwd_turns", []).append(fwd)
            out.setdefault(f"{name}_fwdbwd_turns", []).append(fb)
    # a profiler session opened after others in one process lost its first kernels (in
    # chip_smoke.py, after profile_step's), even after a warm-up cycle: one session is
    # spent before the measured ones, and each of those has a warm-up cycle too
    with torch.profiler.profile(activities=acts):
        both(order[0])
        torch.cuda.synchronize()
    for name in order:
        for part in ("fwd", "fwdbwd"):
            ts = out[f"{name}_{part}_turns"]
            out[f"{name}_{part}"] = sum(ts) / len(ts)
        with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=1)) as prof:
            both(name)
            torch.cuda.synchronize()
            prof.step()
            both(name)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        out[f"{name}_device_ms"] = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        out[f"{name}_kernels"] = len(ev)
    bf, by_f = unit_bound(warps, False)
    bb, by_b = unit_bound(warps, True)
    out.update(bound_fwd=bf, bound_bwd=bb, bound_by=by_b if bb >= bf else by_f)
    return out


def report(unit: str, warps: List[tuple], row: dict, tag: str, smi: str) -> None:
    """Print ``time_unit``'s row of ``unit``: each way's forward and forward + backward
    (with its turns) beside the bound, then each way's device time and kernels."""
    px = sum(c.shape[0] * c.shape[1] * c.shape[2] for _, c, _ in warps)
    names = [k[:-len("_fwdbwd")] for k in row if k.endswith("_fwdbwd")]
    for part, label, bound in (("fwd", "forward", row["bound_fwd"]),
                               ("fwdbwd", "forward+backward",
                                row["bound_fwd"] + row["bound_bwd"])):
        print(f"time sampler unit {unit} [{tag}] ({len(warps)} warps, {px} target pixels, "
              f"{sum(w[2] for w in warps)} with dcoords), {label}: " + ", ".join(
                  f"{n} {row[f'{n}_{part}']:.4f} ms ("
                  + "/".join(f"{t:.4f}" for t in row[f"{n}_{part}_turns"]) + ")"
                  for n in names) + f"; bound {bound:.4f} ms ({row['bound_by']}) [{smi}]")
    print(f"profile sampler unit {unit} [{tag}], forward+backward once: " + ", ".join(
        f"{n} {row[f'{n}_device_ms']:.4f} ms device in {row[f'{n}_kernels']} kernels"
        for n in names) + f" [{smi}]")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=None,
                   help="the checkout whose tf_depth_estimation_torch is timed")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit("sampler_units measures an NVIDIA GPU; torch.cuda.is_available() "
                         "is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    pkg = _mod("ops.bilinear_sample")
    tag = os.path.relpath(root)
    print(f"sampler_units: package from {os.path.dirname(os.path.dirname(pkg.__file__))}, "
          f"{torch.cuda.get_device_name(0)} [{smi}]")
    rows = {}
    for unit, warps in units("cuda").items():
        rows[unit] = time_unit(warps, ways(unit))
        report(unit, warps, rows[unit], tag, smi)
    print(json.dumps({"tag": tag, "smi": smi, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
