"""DeMoN-stream depth training, BASELINE config 5 (ref ``train_depth_only_onDemon.py``).

The truncated DepthPoseNet on DeMoN image pairs at 192x256, batch 16: the smoothness of
1/disp at scales 2 and 3 (``on_demon_loss``; the reference's quirk, its total is the
smoothness alone; ``--optimize_depth`` adds the L1 depth term, the script's evident
intent); Adam at a constant rate; checkpoints of the group ``model`` every 100 steps. On
the GPU the step's two smoothness terms run ``csrc/smoothness.cu`` once each way. ::

    python -m tf_depth_estimation_torch.train.experiments.on_demon \\
        --dataset_dir D [--demon_v1] [--optimize_depth] [--device cpu] [--dtype float32]

``D`` holds DeMoN HDF5 files in the flat schema (``data/synthetic.py:write_demon_h5``), or
with ``--demon_v1`` classic DeMoN v1 archives (``data/demon_v1.py``).
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
    parse,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import make_on_demon_step


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=16, max_steps=200000)
    p.set_defaults(save_latest_freq=100)
    p.add_argument("--image_height", type=int, default=192)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--optimize_depth", action="store_true",
                   help="also optimize the L1 depth term (the reference computes but drops it)")
    return parse(p, argv)


def loss_weights(args) -> LossWeights:
    """``LossWeights.on_demon`` at the run's size and step count."""
    return dataclasses.replace(LossWeights.on_demon(), height=args.image_height,
                               width=args.image_width, max_steps=args.max_steps)


def make_state(args) -> TrainState:
    """The truncated DepthPoseNet (seeded init) and Adam at the constant rate."""
    model = DepthPoseNet(full_resolution=False,
                         generator=torch.Generator().manual_seed(args.seed),
                         dtype=compute_dtype(args)).to(args.device)
    return create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)


def make_step(args, w: LossWeights):
    """The config-5 step: smoothness alone, unless ``--optimize_depth``."""
    return make_on_demon_step(w, smooth_only=not args.optimize_depth)


def train(args, w: LossWeights, state: TrainState, batches: Iterator[dict]):
    """Config 5 over DeMoN ``batches`` to ``--max_steps``; returns (state, the last
    logged metrics)."""
    mgr, logger, state = setup_run(args, state)
    state, last = run_training(
        state=state, train_step=make_step(args, w),
        batches=batches, max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq)
    logger.close()
    return state, last


def main(argv=None):
    args = parse_args(argv)
    return train(args, loss_weights(args), make_state(args),
                 demon_loader(args, args.image_height, args.image_width))


if __name__ == "__main__":
    main()
