"""Where the device time of a training step goes: ``torch.profiler`` over a few steps,
device time summed by kernel and by kind of work.

    python -m tf_depth_estimation_torch.train.profile_step [--config optflow_combine]
        [--steps 3] [--sampler pallas] [--smoothness kernel]

``--config optflow_combine`` (BASELINE config 4: depth10_flow, 224x480) or ``depth_only``
(config 2: depth4, 240x720), bf16, batch 10, as the CLIs train. ``--smoothness plain``
routes the smoothness terms to the plain version for the measurement, as a yardstick for
the kernels (the port itself always runs them). The batch is synthetic
(``data/synthetic.py:make_pair_scene``, on the device before the window), the weights
random from seed 0. Prints the top kernels, the share
of each kind, the steps' wall time and the device's busy share (kernel time over wall
time; overlapping kernels count twice, so it is an upper bound).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from tf_depth_estimation_torch.data.synthetic import make_pair_scene, pose_matrix
from tf_depth_estimation_torch.losses import pipelines
from tf_depth_estimation_torch.losses.basic import second_order_smoothness
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_only_step, make_optflow_combine_step

# config -> (model variant, LossWeights table, step factory)
CONFIGS = {
    "optflow_combine": (DispNetVariant.depth10_flow, LossWeights.optflow_combine,
                        make_optflow_combine_step),
    "depth_only": (DispNetVariant.depth4, LossWeights.depth_only, make_depth_only_step),
}

# kernel-name fragments -> kind of work, first match wins
KINDS = (("bilinear_sample", "bilinear_sample kernel"), ("smooth_", "smoothness kernels"),
         ("conv", "convolution"),
         ("gemm", "convolution"), ("xmma", "convolution"), ("cudnn", "convolution"),
         ("wgrad", "convolution"), ("dgrad", "convolution"), ("multi_tensor", "adam"),
         ("reduce", "reduction"), ("gather", "gather/scatter"),
         ("scatter", "gather/scatter"), ("index", "gather/scatter"), ("cat", "copy/cat"),
         ("copy", "copy/cat"), ("elementwise", "elementwise"), ("vectorized", "elementwise"))


@contextlib.contextmanager
def plain_smoothness():
    """Within the block the loss pipelines compute their smoothness terms with the plain
    version instead of ``smoothness_fused``: a yardstick for measurements only."""
    saved = pipelines.smoothness_fused
    pipelines.smoothness_fused = second_order_smoothness
    try:
        yield
    finally:
        pipelines.smoothness_fused = saved


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for frag, k in KINDS if frag in low), "other")


def pair_batch(batch: int, height: int, width: int, seed: int, device) -> dict:
    rng = np.random.RandomState(seed)
    tgt, src, depth, K, pose6 = (np.stack(a) for a in zip(
        *[make_pair_scene(rng, height, width) for _ in range(batch)]))
    pyr = np.array([[[[k[0, 0] / 2**s, 0, k[0, 2] / 2**s], [0, k[1, 1] / 2**s,
                                                            k[1, 2] / 2**s], [0, 0, 1]]
                     for s in range(4)] for k in K], np.float32)
    projs = np.stack([np.stack([pose_matrix(p), np.linalg.inv(pose_matrix(p))])
                      for p in pose6]).astype(np.float32)
    arrays = {"tgt_image": tgt, "src_image": src, "label": depth[..., None],
              "intrinsics": pyr, "tgt2src_projs": projs}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in arrays.items()}


def profile(steps: int = 3, sampler: str = "pallas", device="cuda", batch: int = 10,
            height: int = None, width: int = None, top: int = 25,
            config: str = "optflow_combine", smoothness: str = "kernel") -> dict:
    """Profile ``steps`` bf16 steps of ``config`` after 2 warm-up steps, at the config's
    size unless ``height`` and ``width`` are given; prints the table and returns
    ``{"wall_ms", "kernel_ms", "launches", "kinds"}`` per step. ``sampler`` picks config
    4's warp sampler, ``smoothness`` the kernels or the plain version."""
    variant, table, make_step = CONFIGS[config]
    w = table()
    w = dataclasses.replace(w, height=height or w.height, width=width or w.width,
                            **({"sampler": sampler} if config == "optflow_combine" else {}))
    height, width = w.height, w.width
    model = DispNet(variant(), generator=torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16).to(device)
    state = create_train_state(model)
    step = make_step(w)
    data = pair_batch(batch, height, width, 0, device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with plain_smoothness() if smoothness == "plain" else contextlib.nullcontext():
        for _ in range(2):
            step(state, data)
        sync()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, data)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events, less the user-annotation ranges (``Optimizer.step#Adam.step``)
    # that span the kernels they contain
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = sum(t for t, _ in by_name.values())
    what = (f"sampler={sampler}, " if config == "optflow_combine" else "") \
        + f"smoothness={smoothness}, "
    print(f"profile: {config}, bfloat16, {height}x{width}, batch {batch}, {what}"
          f"{steps} steps: wall {wall_us / steps / 1e3:.2f} ms/step (profiler on), kernel "
          f"time {busy / steps / 1e3:.2f} ms/step, busy share {busy / wall_us:.1%}, "
          f"{len(kernels) // steps} kernel launches/step")
    kinds = collections.defaultdict(float)
    for name, (t, _) in by_name.items():
        kinds[kind_of(name)] += t
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  kind {kind}: {t / steps / 1e3:.3f} ms/step ({t / busy:.1%})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t / steps / 1e3:8.3f} ms/step  {n // steps:5d}x  [{kind_of(name)}] "
              f"{name[:110]}")
    return {"wall_ms": wall_us / steps / 1e3, "kernel_ms": busy / steps / 1e3,
            "launches": len(kernels) // steps,
            "kinds": {k: t / steps / 1e3 for k, t in kinds.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="optflow_combine", choices=sorted(CONFIGS))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--sampler", default="pallas", choices=["pallas", "xla"])
    p.add_argument("--smoothness", default="kernel", choices=["kernel", "plain"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    return profile(args.steps, args.sampler, args.device, config=args.config,
                   smoothness=args.smoothness)


if __name__ == "__main__":
    main()
