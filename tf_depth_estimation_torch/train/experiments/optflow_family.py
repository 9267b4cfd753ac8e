"""The small colon-pair experiment family, one CLI for five modes (ref
``tf_depth_estimation_tpu/train/experiments/optflow_family.py``):

``--mode only_image``   ref ``train_onlyimage.py``: depth4 DispNet on the stacked pair,
                        the GT-transform photometric term and smoothness;
``--mode optflow_only`` ref ``train_optflow_only.py``: sfm DispNet on the target image,
                        channels 0 and 1 of its heads a flow, flow-warp photometric,
                        smoothness and the flow of the GT-depth warp;
``--mode optflow3``     ref ``train_optflow.py``: sfm DispNet on the stacked pair, the
                        3-channel prediction's L1 to the label and smoothness;
``--mode pre``          ref ``train_pre.py``: depth4 DispNet on the target image, the
                        config-2 loss;
``--mode sfm``          ref ``train.py``: sfm DispNet on the target image, SfMLearner's
                        multi-source loss (its total is smooth + depth; the warps are
                        computed for the record).

Every mode reads 240x720 colon pairs resized to 224x480 (the CLI's size replaces the
preset's), batch 10. On the GPU each step's smoothness terms run ``csrc/smoothness.cu``
once each way (3-channel heads as their channel views) and its warps the sampler kernels
(``csrc/bilinear_sample.cu``) where the preset's sampler is ``"pallas"``. ::

    python -m tf_depth_estimation_torch.train.experiments.optflow_family --mode MODE \\
        --dataset_dir D --checkpoint_dir C [--device cpu] [--dtype float32]

Writes ``C/metrics.jsonl`` and ``C/model-<step>.npz`` (+ ``.opt.pt``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    pair_loader,
    parse,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import (
    make_depth_only_step,
    make_only_image_step,
    make_optflow3_step,
    make_optflow_only_step,
    make_sfm_multi_step,
)

# mode -> (loss weights, DispNet variant, input channels, step factory)
MODES = {
    "only_image": (LossWeights.only_image, DispNetVariant.depth4, 6, make_only_image_step),
    "optflow_only": (LossWeights.optflow_only, DispNetVariant.sfm, 3,
                     make_optflow_only_step),
    "optflow3": (LossWeights.optflow3, DispNetVariant.sfm, 6, make_optflow3_step),
    "pre": (LossWeights.depth_only, DispNetVariant.depth4, 3, make_depth_only_step),
    "sfm": (LossWeights.sfm_multi, DispNetVariant.sfm, 3, make_sfm_multi_step),
}


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=10, max_steps=20000)
    p.add_argument("--mode", choices=sorted(MODES), required=True)
    p.add_argument("--image_height", type=int, default=240)
    p.add_argument("--image_width", type=int, default=720)
    p.add_argument("--resized_height", type=int, default=224)
    p.add_argument("--resized_width", type=int, default=480)
    return parse(p, argv)


def loss_weights(args) -> LossWeights:
    """The mode's preset at the resized size and the run's step count."""
    return dataclasses.replace(MODES[args.mode][0](), height=args.resized_height,
                               width=args.resized_width, max_steps=args.max_steps)


def make_state(args) -> TrainState:
    """The mode's DispNet (seeded init) and Adam at the constant rate."""
    _, variant, in_channels, _ = MODES[args.mode]
    model = DispNet(variant(), generator=torch.Generator().manual_seed(args.seed),
                    dtype=compute_dtype(args), in_channels=in_channels).to(args.device)
    return create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)


def make_step(args, w: LossWeights):
    return MODES[args.mode][3](w)


def batches(args) -> Iterator[dict]:
    """Shuffled colon-pair batches of the train split on ``args.device``."""
    ds = PairDepthDataset(args.dataset_dir, split="train", image_height=args.image_height,
                          image_width=args.image_width, resized_height=args.resized_height,
                          resized_width=args.resized_width)
    return pair_loader(args, ds, args.batch_size)


def train(args, w: LossWeights, state: TrainState, batches: Iterator[dict]):
    """The mode over ``batches`` to ``--max_steps``; returns (state, the last logged
    metrics)."""
    mgr, logger, state = setup_run(args, state)
    state, last = run_training(
        state=state, train_step=make_step(args, w), batches=batches,
        max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq)
    logger.close()
    return state, last


def main(argv=None):
    args = parse_args(argv)
    return train(args, loss_weights(args), make_state(args), batches(args))


if __name__ == "__main__":
    main()
