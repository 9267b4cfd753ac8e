"""Eval harnesses (ref ``split_training_test_pairnet.py`` / ``split_training_test_singlenet.py``).

Runs trained checkpoints in inference mode over the DeMoN stream in test order and
reports the mean of each loss component that the training graphs optimise, the
reference's notion of testing: the loss graph re-run without weight updates.

``--net pair``   the full-resolution DepthPoseNet, eval forwards on (L | R) and (R | L),
                 under the full-scale pairtest losses (``pairwise_depth_loss(...,
                 full_scales=True)``); checkpoint group ``model_pairdepth`` in
                 ``--checkpoint_dir``.
``--net single`` the same pair net, then depth4 DispNet over [nearest-upsampled pair
                 disparity | left image] under ``single_depth_loss``; its group
                 ``model_singledepth`` in ``--checkpoint_dir_single``.

The losses take ``LossWeights.split_training`` at the run's size, at its last step (the
sig weight fully ramped). Every sig term runs ``csrc/sig_l2.cu`` on the GPU; the warps take
the preset's plain sampler. A net without a checkpoint keeps its seeded init. ::

    python -m tf_depth_estimation_torch.train.experiments.eval_harness \\
        --dataset_dir D [--net pair|single] [--device cpu] [--dtype float32]
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

import torch

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.losses.pipelines import pairwise_depth_loss, single_depth_loss
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.ops.resize import resize_nearest
from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    demon_loader,
)
from tf_depth_estimation_torch.utils.npz import load_variables_npz
from tf_depth_estimation_torch.weights import load_variables

PAIR_GROUP, SINGLE_GROUP = "model_pairdepth", "model_singledepth"


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=16, max_steps=20000)
    p.add_argument("--net", choices=["pair", "single"], default="pair")
    p.add_argument("--image_height", type=int, default=192)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--eval_batches", type=int, default=10)
    p.add_argument("--checkpoint_dir_single", default="./checkpoints_single")
    return p.parse_args(argv)


def loss_weights(args) -> LossWeights:
    return dataclasses.replace(LossWeights.split_training(), height=args.image_height,
                               width=args.image_width)


def _restore(model: torch.nn.Module, directory: str, group: str) -> None:
    """The newest ``<group>-<step>.npz`` of ``directory`` into ``model``, if any. A tree of
    other layers or shapes raises ``RuntimeError`` before anything is loaded."""
    mgr = CheckpointManager(directory, group)
    if mgr.latest_step() is None:
        return
    path = mgr.weights_path(mgr.latest_step())
    try:
        load_variables(model, load_variables_npz(path)[0])
    except RuntimeError as e:
        raise RuntimeError(f"{path}: {e}") from e


def pair_model(args) -> DepthPoseNet:
    """The full-resolution DepthPoseNet in eval mode, from the newest ``model_pairdepth``
    checkpoint; a checkpoint of another shape (the truncated net of split_training) is
    reported and the seeded init kept, as the JAX harness does."""
    model = DepthPoseNet(full_resolution=True,
                         generator=torch.Generator().manual_seed(args.seed),
                         dtype=compute_dtype(args))
    try:
        _restore(model, args.checkpoint_dir, PAIR_GROUP)
    except RuntimeError as e:
        print(f"warning: could not restore pair checkpoint: {e}")
    return model.to(args.device).eval()


def single_model(args) -> DispNet:
    """depth4 DispNet over 4 channels in eval mode, from the newest ``model_singledepth``
    checkpoint in ``--checkpoint_dir_single``."""
    model = DispNet(DispNetVariant.depth4(), in_channels=4,
                    generator=torch.Generator().manual_seed(args.seed),
                    dtype=compute_dtype(args))
    _restore(model, args.checkpoint_dir_single, SINGLE_GROUP)
    return model.to(args.device).eval()


def make_eval_fn(w: LossWeights, pair: DepthPoseNet,
                 single: Optional[DispNet] = None) -> Callable[[dict], Dict[str, torch.Tensor]]:
    """batch -> loss components of one DeMoN batch: the pair net's losses, or with
    ``single`` the single net's. Both nets run their eval forwards without gradients."""
    H, W = w.height, w.width

    @torch.no_grad()
    def eval_pair(batch):
        pair_img = batch["image_pair"]
        left, right = pair_img[..., :3], pair_img[..., 3:]
        d_l, pose_r, exp_l = pair.forward_nhwc(pair_img)
        d_r, pose_l, exp_r = pair.forward_nhwc(torch.cat([right, left], -1))
        gt_cam = torch.cat([batch["translation"], batch["rotation"]], -1)
        _, comps = pairwise_depth_loss(
            left, right, d_l, pose_r, exp_l, d_r, pose_l, exp_r, gt_cam,
            batch["intrinsics"], batch["depth0"], w.max_steps, w, full_scales=True)
        return comps

    @torch.no_grad()
    def eval_single(batch):
        pair_img = batch["image_pair"]
        disps, _pose, _masks = pair(pair_img.permute(0, 3, 1, 2))
        coarse = resize_nearest(disps[0], (H, W)).permute(0, 2, 3, 1)
        preds = single.forward_nhwc(torch.cat([coarse, pair_img[..., :3]], -1))
        _, comps = single_depth_loss(preds, batch["depth0"], w.max_steps, w)
        return comps

    return eval_pair if single is None else eval_single


def evaluate(eval_fn: Callable, batches: Iterator[dict], n: int) -> Dict[str, float]:
    """The mean of each component over ``n`` batches (fewer if the stream ends),
    printed as the JAX harness prints it."""
    sums: Dict[str, float] = {}
    count = 0
    for _ in range(n):
        try:
            batch = next(batches)
        except StopIteration:
            break
        for k, v in eval_fn(batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    means = {k: v / max(count, 1) for k, v in sums.items()}
    print(" ".join(f"{k}={v:.5g}" for k, v in sorted(means.items())))
    return means


def main(argv=None):
    args = parse_args(argv)
    w = loss_weights(args)
    single = single_model(args) if args.net == "single" else None
    eval_fn = make_eval_fn(w, pair_model(args), single)
    batches = demon_loader(args, args.image_height, args.image_width, test_phase=True)
    return evaluate(eval_fn, batches, args.eval_batches)


if __name__ == "__main__":
    main()
