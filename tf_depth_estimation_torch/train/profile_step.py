"""Where the device time of a training step goes: ``torch.profiler`` over a few steps,
device time summed by kernel and by kind of work.

    python -m tf_depth_estimation_torch.train.profile_step [--config optflow_combine]
        [--steps 3] [--sampler kernel] [--smoothness kernel] [--sig kernel]

``--config optflow_combine`` (BASELINE config 4: depth10_flow, 224x480, batch 10),
``depth_only`` (config 2: depth4, 240x720, batch 10), ``depth_then_cam`` (config 3: the
full-resolution DepthPoseNet on a DeMoN pair, 192x256, batch 16), ``split_pair``
(split_training's phase 1: the truncated DepthPoseNet on a DeMoN pair, 192x256, batch 1)
``split_single`` (its phase 2: depth4 DispNet over [coarse depth | image], 192x256,
batch 1), ``depth_only_turbo`` (config 2T: turbo-colon on config 2's batch), ``distill``
(turbo-base learning a seeded depth4 teacher's pyramid through the teacher's folded
forward, 576x384, batch 8), ``on_demon`` (config 5: the truncated DepthPoseNet on a DeMoN
pair, 192x256, batch 16), ``lr_full`` (``depth_then_cam_lr``: LRNet on a DeMoN pair,
192x256, batch 16), ``lr_gt`` (``depth_then_cam_lr --gt_pose``), the colon-pair family's
``optflow_family_{only_image,optflow_only,optflow3,pre,sfm}`` (``optflow_family --mode
...``: DispNet depth4 or sfm, 224x480, batch 10) or ``dim11`` (the full-resolution
DepthPoseNet on a colon pair in [-0.5, 0.5], 224x224, batch 10), bf16, as the CLIs train,
the DeMoN-stream and colon-pair configs built by their CLIs' own functions, or ``refine``
(test-time refinement, ``infer/refine.py``'s own state and step: depth4 DispNet in
float32, as ``refine_depth`` runs it, on one ``colmap_pair_scene`` pair at 224x224,
batch 1; ``--sampler kernel`` is the sampler kernels and ``plain`` the plain sampler,
whatever the preset ``infer/refine.py:SAMPLER``).
``--sampler plain`` (the warps of configs 3 and 4 and of the colon-pair family, and the
samplings of the L/R family), ``--smoothness plain`` and ``--sig plain`` route those terms
to their plain versions for the measurement, as a yardstick for the kernels (the port
itself always runs them). The batch is synthetic (``data/synthetic.py``'s scenes, on the
device before the window), the weights random from seed 0. Prints the top kernels, the
share of each kind, the steps' wall time and the device's busy share (kernel time over
wall time; overlapping kernels count twice, so it is an upper bound).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from tf_depth_estimation_torch.data.demon import DemonReaderParams, augment, preprocess
from tf_depth_estimation_torch.data.pipeline import BatchLoader, to_device
from tf_depth_estimation_torch.data.synthetic import (
    colmap_pair_scene,
    demon_record,
    make_pair_scene,
    pose_matrix,
)
from tf_depth_estimation_torch.infer import refine
from tf_depth_estimation_torch.losses import pipelines
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_plain_group
from tf_depth_estimation_torch.ops.smoothness import smoothness_plain_group
from tf_depth_estimation_torch.train.distill import folded_teacher, make_distill_step
from tf_depth_estimation_torch.train.experiments import (
    depth_then_cam_lr,
    dim11,
    on_demon,
    optflow_family,
)
from tf_depth_estimation_torch.train.experiments.split_training import single_batches
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.weights import state_dict_to_variables
from tf_depth_estimation_torch.train.steps import (
    make_depth_only_step,
    make_depth_then_cam_step,
    make_optflow_combine_step,
    make_pairwise_step,
    make_single_depth_step,
)

# kernel-name fragments -> kind of work, first match wins
KINDS = (("bilinear_group", "sampler kernels"),
         ("smooth_", "smoothness kernels"), ("tail_", "fused tail kernel"),
         ("sig_", "sig kernels"), ("conv", "convolution"),
         ("gemm", "convolution"), ("xmma", "convolution"), ("cudnn", "convolution"),
         ("wgrad", "convolution"), ("dgrad", "convolution"), ("multi_tensor", "adam"),
         ("reduce", "reduction"), ("gather", "gather/scatter"),
         ("scatter", "gather/scatter"), ("index", "gather/scatter"), ("cat", "copy/cat"),
         ("copy", "copy/cat"), ("elementwise", "elementwise"), ("vectorized", "elementwise"))


@contextlib.contextmanager
def plain_smoothness():
    """Within the block the loss pipelines compute their smoothness terms with the plain
    version (``smoothness_plain_group``) instead of ``smoothness_fused_group``: a
    yardstick for measurements only."""
    saved = pipelines.smoothness_fused_group
    pipelines.smoothness_fused_group = smoothness_plain_group
    try:
        yield
    finally:
        pipelines.smoothness_fused_group = saved


@contextlib.contextmanager
def plain_sig():
    """Within the block the loss pipelines compute their sig terms with the plain
    composition (``sig_l2_plain_group``) instead of ``sig_l2_fused_group``: a yardstick
    for measurements only."""
    saved = pipelines.sig_l2_fused_group
    pipelines.sig_l2_fused_group = sig_l2_plain_group
    try:
        yield
    finally:
        pipelines.sig_l2_fused_group = saved


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for frag, k in KINDS if frag in low), "other")


def pair_batch(batch: int, height: int, width: int, seed: int, device) -> dict:
    """A colon-pair batch (configs 2 and 4) of ``make_pair_scene`` scenes."""
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


def demon_batch(batch: int, height: int, width: int, rng: np.random.RandomState,
                device) -> dict:
    """A DeMoN batch (split_training) of ``make_pair_scene`` scenes, each drawn from
    ``rng``, augmented and preprocessed as ``data/demon.py:DemonDataset.sample`` does its
    records (the records ``data/synthetic.py:write_demon_h5`` would store)."""
    params = DemonReaderParams(batch_size=batch, scaled_height=height, scaled_width=width)
    samples = [preprocess(params, *augment(params, *demon_record(rng, height, width), rng))
               for _ in range(batch)]
    return to_device(BatchLoader._collate(samples), device)


def _weights(table, height, width, sampler: str) -> LossWeights:
    """``table()`` at the given size (its own where None); ``sampler="plain"`` swaps its
    warp sampler for the plain version, ``"kernel"`` keeps the table's."""
    w = table()
    return dataclasses.replace(w, height=height or w.height, width=width or w.width,
                               **({"sampler": "xla"} if sampler == "plain" else {}))


def _dispnet_setup(variant, table, make_step, default_batch=10, net=DispNet):
    def setup(batch, height, width, device, sampler):
        w = _weights(table, height, width, sampler)
        model = net(variant(), generator=torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16).to(device)
        data = pair_batch(batch or default_batch, w.height, w.width, 0, device)
        return w, create_train_state(model), make_step(w), data
    return setup


def _depth_then_cam_setup(batch, height, width, device, sampler):
    w = _weights(LossWeights.depth_then_cam, height, width, sampler)
    data = demon_batch(batch or 16, w.height, w.width, np.random.RandomState(0), device)
    model = DepthPoseNet(full_resolution=True, generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16).to(device)
    return w, create_train_state(model), make_depth_then_cam_step(w), data


def dim11_batch(batch: int, height: int, width: int, seed: int, device) -> dict:
    """A dim11 batch: ``pair_batch``'s scenes with the pixels scaled to [-0.5, 0.5], as
    ``data/colon.py:Dim11Dataset`` scales them."""
    data = pair_batch(batch, height, width, seed, device)
    for k in ("tgt_image", "src_image"):
        data[k] = data[k] / 255.0 - 0.5
    return data


def _demon_data(batch, height, width, device):
    return demon_batch(batch, height, width, np.random.RandomState(0), device)


def _pair_data(maker):
    return lambda batch, height, width, device: maker(batch, height, width, 0, device)


def _cli_setup(cli, *flags: str, data=_demon_data,
               size=("--image_height", "--image_width")):
    """A CLI's own loss weights, state and step (``cli.loss_weights``, ``make_state``,
    ``make_step`` under ``flags``), bf16 from seed 0, at its defaults where the batch,
    height or width is None; ``size`` names the CLI's flags of the training size and
    ``data(batch, height, width, device)`` makes the batch (a DeMoN batch by default)."""
    def setup(batch, height, width, device, sampler):
        sized = [a for flag, v in (("--batch_size", batch), (size[0], height),
                                   (size[1], width)) if v for a in (flag, str(v))]
        args = cli.parse_args(["--device", str(device), "--dtype", "bfloat16", "--seed", "0",
                               *sized, *flags])
        w = cli.loss_weights(args)
        if sampler == "plain":
            w = dataclasses.replace(w, sampler="xla")
        return (w, cli.make_state(args), cli.make_step(args, w),
                data(args.batch_size, w.height, w.width, device))
    return setup


def _colon_setup(cli, *flags: str):
    """``_cli_setup`` of a colon-pair CLI: optflow_family at its resized size on
    ``pair_batch``, dim11 on ``dim11_batch``."""
    if cli is dim11:
        return _cli_setup(cli, *flags, data=_pair_data(dim11_batch))
    return _cli_setup(cli, *flags, data=_pair_data(pair_batch),
                      size=("--resized_height", "--resized_width"))


def _split_setup(phase: str):
    def setup(batch, height, width, device, sampler):
        w = LossWeights.split_training()
        w = dataclasses.replace(w, height=height or w.height, width=width or w.width)
        data = demon_batch(batch or 1, w.height, w.width, np.random.RandomState(0), device)
        pair = DepthPoseNet(generator=torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16).to(device)
        if phase == "pair":
            return w, create_train_state(pair), make_pairwise_step(w), data
        model = DispNet(DispNetVariant.depth4(), in_channels=4, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(device)
        data = next(single_batches(pair, iter([data])))
        return w, create_train_state(model), make_single_depth_step(w), data
    return setup


def _distill_setup(batch, height, width, device, sampler):
    height, width = height or 384, width or 576
    teacher = DispNet(DispNetVariant.depth4(), generator=torch.Generator().manual_seed(1))
    teacher = folded_teacher(state_dict_to_variables(teacher.state_dict()),
                             dtype=torch.bfloat16, device=device)
    model = TurboDepthNet(TurboVariant.base(), generator=torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16).to(device)
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (batch or 8, height, width, 3)).astype(np.float32)).to(device)
    step = make_distill_step(teacher)
    w = dataclasses.replace(LossWeights.depth_only(), height=height, width=width)
    return w, create_train_state(model), lambda st, d: step(st, d["image"]), {"image": images}


def _refine_setup(batch, height, width, device, sampler):
    """refine_depth's state and step on one pair (batch 1 whatever ``batch``)."""
    height, width = height or 224, width or 224
    scene = colmap_pair_scene(np.random.RandomState(0), height, width)
    inputs = refine.refine_inputs(*scene["images"], scene["relative_pose"], scene["K"],
                                  scene["sparse_xy"], scene["sparse_z"], device=device)
    route = "xla" if sampler == "plain" else "pallas"
    w = dataclasses.replace(LossWeights.depth_only(), height=height, width=width,
                            sampler=route)
    return (w, refine.refine_state(device=device), refine.make_refine_step(sampler=route),
            inputs)


# the DeMoN-stream configs -> (their CLI, its flags)
DEMON_CLIS = {"on_demon": (on_demon, ()), "lr_full": (depth_then_cam_lr, ()),
              "lr_gt": (depth_then_cam_lr, ("--gt_pose",))}
# the colon-pair configs -> (their CLI, its flags); optflow_family trains at its resized
# size, dim11 on [-0.5, 0.5] pixels
COLON_CLIS = {**{f"optflow_family_{mode}": (optflow_family, ("--mode", mode))
                 for mode in sorted(optflow_family.MODES)},
              "dim11": (dim11, ())}
# config -> setup(batch, height, width, device, sampler) -> (LossWeights, TrainState, step,
# batch); a batch, height or width of None takes the configuration's own
CONFIGS = {
    "optflow_combine": _dispnet_setup(DispNetVariant.depth10_flow, LossWeights.optflow_combine,
                                      make_optflow_combine_step),
    "depth_only": _dispnet_setup(DispNetVariant.depth4, LossWeights.depth_only,
                                 make_depth_only_step),
    "depth_then_cam": _depth_then_cam_setup,
    "split_pair": _split_setup("pair"),
    "split_single": _split_setup("single"),
    "depth_only_turbo": _dispnet_setup(TurboVariant.colon, LossWeights.depth_only,
                                       make_depth_only_step, net=TurboDepthNet),
    "distill": _distill_setup,
    **{config: _cli_setup(cli, *flags) for config, (cli, flags) in DEMON_CLIS.items()},
    **{config: _colon_setup(cli, *flags) for config, (cli, flags) in COLON_CLIS.items()},
    "refine": _refine_setup,
}
# the configurations whose warps a sampler runs
SAMPLED = ("optflow_combine", "depth_then_cam", "lr_full", "lr_gt", "dim11", "refine",
           *(f"optflow_family_{m}" for m in ("only_image", "optflow_only", "sfm")))


def profile(steps: int = 3, sampler: str = "kernel", device="cuda", batch: int = None,
            height: int = None, width: int = None, top: int = 25,
            config: str = "optflow_combine", smoothness: str = "kernel",
            sig: str = "kernel") -> dict:
    """Profile ``steps`` bf16 steps of ``config`` after 2 warm-up steps, at the config's
    batch and size unless given; prints the table and returns ``{"wall_ms", "kernel_ms",
    "launches", "kinds", "kind_launches"}`` per step (a kind's device ms and launches). ``sampler``, ``smoothness`` and ``sig`` pick the
    kernels (``"kernel"``) or the plain versions (``"plain"``)."""
    w, state, step, data = CONFIGS[config](batch, height, width, device, sampler)
    batch = next(iter(data.values())).shape[0]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with contextlib.ExitStack() as plain:
        if smoothness == "plain":
            plain.enter_context(plain_smoothness())
        if sig == "plain":
            plain.enter_context(plain_sig())
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
    what = (f"sampler={w.sampler}, " if config in SAMPLED else "") \
        + f"smoothness={smoothness}, sig={sig}, "
    print(f"profile: {config}, {'float32' if config == 'refine' else 'bfloat16'}, "
          f"{w.height}x{w.width}, batch {batch}, {what}"
          f"{steps} steps: wall {wall_us / steps / 1e3:.2f} ms/step (profiler on), kernel "
          f"time {busy / steps / 1e3:.2f} ms/step, busy share {busy / wall_us:.1%}, "
          f"{len(kernels) // steps} kernel launches/step")
    kinds = collections.defaultdict(float)
    kind_launches = collections.defaultdict(int)
    for name, (t, n) in by_name.items():
        kinds[kind_of(name)] += t
        kind_launches[kind_of(name)] += n
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  kind {kind}: {t / steps / 1e3:.3f} ms/step ({t / busy:.1%})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t / steps / 1e3:8.3f} ms/step  {n // steps:5d}x  [{kind_of(name)}] "
              f"{name[:110]}")
    return {"wall_ms": wall_us / steps / 1e3, "kernel_ms": busy / steps / 1e3,
            "launches": len(kernels) // steps,
            "kinds": {k: t / steps / 1e3 for k, t in kinds.items()},
            "kind_launches": {k: n / steps for k, n in kind_launches.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="optflow_combine", choices=sorted(CONFIGS))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--sampler", default="kernel", choices=["kernel", "plain"])
    p.add_argument("--smoothness", default="kernel", choices=["kernel", "plain"])
    p.add_argument("--sig", default="kernel", choices=["kernel", "plain"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    return profile(args.steps, args.sampler, args.device, config=args.config,
                   smoothness=args.smoothness, sig=args.sig)


if __name__ == "__main__":
    main()
