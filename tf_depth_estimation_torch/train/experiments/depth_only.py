"""Supervised depth training, BASELINE config 2 (ref ``train_depth_only.py``).

depth4 DispNet (sigmoid * 4 heads) on the target image of 240x720 colon pairs; L1 depth
and second-order smoothness per scale, and every ``--validation_check`` steps one
validation batch through the eval forward with the reference's si-log-RMSE (ref
``train_depth_only.py:353-377``). ``--turbo <preset>`` trains a ``TurboDepthNet`` of that
preset instead, with the same 4-scale loss pyramid ('colon' fits 240x720, divisibility
16); its checkpoint group stays ``model``, and ``infer/cli.py --mode turbo
--checkpoint_group model`` serves it. The smoothness terms run the port's CUDA kernels on
the GPU. ::

    python -m tf_depth_estimation_torch.train.experiments.depth_only \\
        --dataset_dir D --checkpoint_dir C [--device cpu] [--dtype float32]

Writes ``C/metrics.jsonl`` (``"train"`` and ``"val"`` records) and ``C/model-<step>.npz``
(+ ``.opt.pt``). A dataset without a ``val.txt`` split trains without validation.
``--native_loader`` decodes through the C++ loader; ``--tensorboard`` mirrors the records
to ``C/sum``, and ``--rich_summaries`` adds the image and histogram summaries there every
``--image_summary_freq`` steps (``train/summaries.py:make_depth_summary_fn``).
"""
from __future__ import annotations

import dataclasses

import torch

from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    pair_loader,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_only_step, make_depth_only_val_step
from tf_depth_estimation_torch.train.summaries import make_depth_summary_fn


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=10, max_steps=20000)
    p.add_argument("--image_height", type=int, default=240)
    p.add_argument("--image_width", type=int, default=720)
    p.add_argument("--turbo", default="",
                   help="train a TurboDepthNet of this preset (TurboVariant.PRESETS) "
                        "instead of depth4 DispNet; 'colon' fits 240x720")
    args = p.parse_args(argv)
    if args.turbo:
        try:
            TurboVariant.by_name(args.turbo).check_size(args.image_height,
                                                        args.image_width)
        except ValueError as e:
            p.error(str(e))
    return args


def _loader(args, split: str, batch_size: int):
    H, W = args.image_height, args.image_width
    ds = PairDepthDataset(args.dataset_dir, split=split, image_height=H, image_width=W,
                          resized_height=H, resized_width=W)
    return pair_loader(args, ds, batch_size)


def validation(args, w: LossWeights):
    """``val_fn`` for ``run_training``: the next pair of the val split (batch 1, its
    loader built at the first call) through ``make_depth_only_val_step``, or None when the
    dataset has no val split or it is used up."""
    val_step = make_depth_only_val_step(w)
    batches = None

    def val_fn(state):
        nonlocal batches
        try:
            if batches is None:
                batches = _loader(args, "val", 1)
            return val_step(state, next(batches))
        except (FileNotFoundError, StopIteration):
            return None

    return val_fn


def main(argv=None):
    args = parse_args(argv)
    w = dataclasses.replace(LossWeights.depth_only(), height=args.image_height,
                            width=args.image_width, max_steps=args.max_steps)
    batches = _loader(args, "train", args.batch_size)
    g = torch.Generator().manual_seed(args.seed)
    if args.turbo:
        model = TurboDepthNet(TurboVariant.by_name(args.turbo), generator=g,
                              dtype=compute_dtype(args))
    else:
        model = DispNet(DispNetVariant.depth4(), generator=g, dtype=compute_dtype(args))
    model = model.to(args.device)
    state = create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)
    mgr, logger, state = setup_run(args, state)
    state, last = run_training(
        state=state, train_step=make_depth_only_step(w), batches=batches,
        max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq,
        validation_check=args.validation_check, val_fn=validation(args, w),
        image_summary_fn=make_depth_summary_fn(w) if args.rich_summaries else None,
        image_summary_freq=args.image_summary_freq)
    logger.close()
    return state, last


if __name__ == "__main__":
    main()
