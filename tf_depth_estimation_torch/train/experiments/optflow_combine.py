"""Joint depth + optical flow, BASELINE config 4 (ref ``train_optflow_combine.py``).

depth10_flow DispNet (depth and flow decoders) on 224x480 colon pairs read at 240x720;
depth L1, smoothness of depth and both flow channels, wmask-weighted photometric error of
the depth warp and the flow warp, and flow supervised by the GT-depth warp. The warps run
the port's bilinear-sample kernel on the GPU. ::

    python -m tf_depth_estimation_torch.train.experiments.optflow_combine \\
        --dataset_dir D --checkpoint_dir C [--device cpu] [--dtype float32]

Writes ``C/metrics.jsonl`` and ``C/model-<step>.npz`` (+ ``.opt.pt``).
"""
from __future__ import annotations

import dataclasses

import torch

from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    pair_loader,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_optflow_combine_step
from tf_depth_estimation_torch.train.summaries import make_depth_summary_fn


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=10, max_steps=20000)
    p.add_argument("--image_height", type=int, default=240)
    p.add_argument("--image_width", type=int, default=720)
    p.add_argument("--resized_height", type=int, default=224)
    p.add_argument("--resized_width", type=int, default=480)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    H, W = args.resized_height, args.resized_width
    w = dataclasses.replace(LossWeights.optflow_combine(), height=H, width=W,
                            max_steps=args.max_steps)
    ds = PairDepthDataset(args.dataset_dir, split="train",
                          image_height=args.image_height, image_width=args.image_width,
                          resized_height=H, resized_width=W)
    batches = pair_loader(args, ds, args.batch_size)
    model = DispNet(DispNetVariant.depth10_flow(),
                    generator=torch.Generator().manual_seed(args.seed),
                    dtype=compute_dtype(args)).to(args.device)
    state = create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)
    mgr, logger, state = setup_run(args, state)
    state, last = run_training(
        state=state, train_step=make_optflow_combine_step(w), batches=batches,
        max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq,
        image_summary_fn=make_depth_summary_fn(w) if args.rich_summaries else None,
        image_summary_freq=args.image_summary_freq)
    logger.close()
    return state, last


if __name__ == "__main__":
    main()
