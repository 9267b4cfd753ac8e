"""Full symmetric L/R training (ref ``train_depth_then_cam_lr.py``), and with ``--gt_pose``
its GT-supervised variant (ref ``train_depth_then_cam_lr_gtdepth_gtcam.py``).

``LRNet`` on DeMoN image pairs at 192x256, batch 16: a depth4 DispNet on each view (shared
weights) and the full-resolution DepthPoseNet on (L | R) and on (R | L), under
``lr_full_loss`` (photometric warps with the predicted angle-axis poses, the smoothness of
1/d on all four depth pyramids, the full-4x4 pose MSE at scale 0, the L/R inverse-depth
consistency and the guarded depth L1 on the single net). ``--gt_pose`` drops the single
net and trains under ``lr_gt_pose_loss`` (warps with the predicted pose matrices, the
asymmetric rotation / translation cam loss, an un-ramped 5-delta sig term). Adam at a
constant rate; checkpoints of the group ``model``. On the GPU a step's 16 samplings run
``csrc/bilinear_sample.cu`` once each way, its smoothness terms ``csrc/smoothness.cu``, and
under ``--gt_pose`` its sig term ``csrc/sig_l2.cu``. ::

    python -m tf_depth_estimation_torch.train.experiments.depth_then_cam_lr \\
        --dataset_dir D [--gt_pose] [--demon_v1] [--device cpu] [--dtype float32]

``D`` holds DeMoN HDF5 files in the flat schema, or with ``--demon_v1`` classic v1
archives.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.composite import LRNet
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    demon_loader,
    parse,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import make_lr_full_step, make_lr_gt_step


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=16, max_steps=200000)
    p.add_argument("--image_height", type=int, default=192)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--gt_pose", action="store_true",
                   help="gtdepth_gtcam variant (GT-pose warps, sig loss)")
    return parse(p, argv)


def loss_weights(args) -> LossWeights:
    """``LossWeights.gtdepth_gtcam`` under ``--gt_pose``, else ``depth_then_cam_lr``, at
    the run's size and step count."""
    base = LossWeights.gtdepth_gtcam() if args.gt_pose else LossWeights.depth_then_cam_lr()
    return dataclasses.replace(base, height=args.image_height, width=args.image_width,
                               max_steps=args.max_steps)


def make_state(args) -> TrainState:
    """``LRNet`` (with the single-view net unless ``--gt_pose``; seeded init) and Adam at
    the constant rate."""
    model = LRNet(with_single=not args.gt_pose,
                  generator=torch.Generator().manual_seed(args.seed),
                  dtype=compute_dtype(args)).to(args.device)
    return create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)


def make_step(args, w: LossWeights):
    """The ``lr_gt`` step under ``--gt_pose``, else the ``lr_full`` step."""
    return make_lr_gt_step(w) if args.gt_pose else make_lr_full_step(w)


def train(args, w: LossWeights, state: TrainState, batches: Iterator[dict]):
    """The L/R family over DeMoN ``batches`` to ``--max_steps``; returns (state, the last
    logged metrics)."""
    mgr, logger, state = setup_run(args, state)
    state, last = run_training(
        state=state, train_step=make_step(args, w), batches=batches, max_steps=args.max_steps,
        logger=logger, checkpoint=mgr, save_latest_freq=args.save_latest_freq,
        summary_freq=args.summary_freq)
    logger.close()
    return state, last


def main(argv=None):
    args = parse_args(argv)
    return train(args, loss_weights(args), make_state(args),
                 demon_loader(args, args.image_height, args.image_width))


if __name__ == "__main__":
    main()
