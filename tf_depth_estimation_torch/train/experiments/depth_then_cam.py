"""Self-supervised joint depth and pose, BASELINE config 3 (ref ``train_depth_then_cam.py``).

The full-resolution DepthPoseNet (the reference script indexes 4 scales) on DeMoN image
pairs at 192x256, batch 16: per scale the explainability-weighted photometric L1 of the
right image warped with the predicted Euler pose, the smoothness of 1/disp and the
explainability cross-entropy (``depth_then_cam_loss``); Adam at a constant rate;
checkpoints of the group ``model`` in ``--checkpoint_dir``. On the GPU the step's warps
run the fused sampler kernels (``ops/bilinear_sample_fused.py``) once each way and its
smoothness terms ``csrc/smoothness.cu``. ::

    python -m tf_depth_estimation_torch.train.experiments.depth_then_cam \\
        --dataset_dir D [--device cpu] [--dtype float32]

``D`` holds DeMoN HDF5 files in the flat schema (``data/synthetic.py:write_demon_h5``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    demon_loader,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_then_cam_step


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=16, max_steps=200000)
    p.set_defaults(summary_freq=1000)
    p.add_argument("--image_height", type=int, default=192)
    p.add_argument("--image_width", type=int, default=256)
    return p.parse_args(argv)


def loss_weights(args) -> LossWeights:
    """``LossWeights.depth_then_cam`` at the run's size and step count."""
    return dataclasses.replace(LossWeights.depth_then_cam(), height=args.image_height,
                               width=args.image_width, max_steps=args.max_steps)


def make_state(args) -> TrainState:
    """The full-resolution DepthPoseNet (seeded init) and Adam at the constant rate."""
    model = DepthPoseNet(full_resolution=True,
                         generator=torch.Generator().manual_seed(args.seed),
                         dtype=compute_dtype(args)).to(args.device)
    return create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)


def train(args, w: LossWeights, state: TrainState, batches: Iterator[dict]):
    """Config 3 over DeMoN ``batches`` to ``--max_steps``; returns (state, the last
    logged metrics)."""
    mgr, logger, state = setup_run(args, state)
    state, last = run_training(
        state=state, train_step=make_depth_then_cam_step(w), batches=batches,
        max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq)
    logger.close()
    return state, last


def main(argv=None):
    args = parse_args(argv)
    return train(args, loss_weights(args), make_state(args),
                 demon_loader(args, args.image_height, args.image_width))


if __name__ == "__main__":
    main()
