"""Two-phase curriculum on DeMoN pairs (ref ``split_training.py``).

Phase 1 ("pair"): the truncated DepthPoseNet on (L | R) and (R | L) with
``pairwise_depth_loss``: depth L1, the camera loss, the explainability and left/right
consistency terms and the ramped sig loss; Adam on a staircase-decayed learning rate
(10000 steps, 0.96, ``split_training.py:330-334``); checkpoints of the group
``model_pairdepth`` in ``--checkpoint_dir``.

Phase 2 ("single"): the phase-1 net, restored from ``--checkpoint_dir`` and frozen, gives
a coarse depth (disp3, nearest-upsampled to full resolution); a depth4 DispNet takes
[coarse depth | left image] (``split_training.py:110-113``) and trains on
``single_depth_loss`` with the constant learning rate (the reference defines a decay here
but hands Adam the constant, ``split_training.py:84-87``); checkpoints of the group
``model_singledepth`` in ``--checkpoint_dir_single``, resumed by
``--continue_train_single``. Every sig term runs the port's CUDA kernel on the GPU. ::

    python -m tf_depth_estimation_torch.train.experiments.split_training \\
        --dataset_dir D [--phase pair|single|both] [--device cpu] [--dtype float32]

``D`` holds DeMoN HDF5 files in the flat schema (``data/synthetic.py:write_demon_h5``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.ops.resize import resize_nearest
from tf_depth_estimation_torch.ops.schedules import exponential_decay
from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    demon_loader,
    fixture_pair,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import MetricLogger, run_training
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import make_pairwise_step, make_single_depth_step
from tf_depth_estimation_torch.train.summaries import make_pairwise_summary_fn

PAIR_GROUP, SINGLE_GROUP = "model_pairdepth", "model_singledepth"


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=1, max_steps=600001)
    p.set_defaults(save_latest_freq=5000)
    p.add_argument("--checkpoint_dir_single", default="./checkpoints_single")
    p.add_argument("--max_steps_single", type=int, default=150001)
    p.add_argument("--image_height", type=int, default=192)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--phase", choices=["pair", "single", "both"], default="both")
    p.add_argument("--continue_train_single", action="store_true")
    return p.parse_args(argv)


def loss_weights(args) -> LossWeights:
    """``LossWeights.split_training`` at the run's size; both phases ramp the sig weight
    over a third of ``--max_steps``, as the JAX CLI does."""
    return dataclasses.replace(LossWeights.split_training(), height=args.image_height,
                               width=args.image_width, max_steps=args.max_steps)


def pair_state(args) -> TrainState:
    """The truncated DepthPoseNet (seeded init) and Adam on the decayed learning rate."""
    model = DepthPoseNet(full_resolution=False,
                         generator=torch.Generator().manual_seed(args.seed),
                         dtype=compute_dtype(args)).to(args.device)
    return create_train_state(model, beta1=args.beta1, lr_schedule=exponential_decay(
        args.learning_rate, 10000, 0.96))


def single_state(args) -> TrainState:
    """depth4 DispNet over 4 channels (seeded init) and Adam on the constant rate."""
    model = DispNet(DispNetVariant.depth4(), in_channels=4,
                    generator=torch.Generator().manual_seed(args.seed),
                    dtype=compute_dtype(args)).to(args.device)
    return create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)


def train_pair(args, w: LossWeights, state: TrainState, batches: Iterator[dict]):
    """Phase 1 over DeMoN ``batches`` to ``--max_steps``; returns the state. Under
    ``--rich_summaries`` every ``--image_summary_freq`` steps the pairwise summaries
    and the fixture pair's inference go to the TensorBoard mirror."""
    mgr, logger, state = setup_run(args, state, group=PAIR_GROUP)
    summary_fn = None
    if args.rich_summaries:
        summary_fn = make_pairwise_summary_fn(
            w, fixture_pair(args, args.image_height, args.image_width))
    state, _ = run_training(
        state=state, train_step=make_pairwise_step(w), batches=batches,
        max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq,
        image_summary_fn=summary_fn, image_summary_freq=args.image_summary_freq)
    logger.close()
    return state


def single_batches(pair_model: DepthPoseNet, batches: Iterator[dict]) -> Iterator[dict]:
    """Phase 2's batches from DeMoN ``batches``: ``input`` = [disp3 of the eval-mode pair
    net, nearest-upsampled to full resolution | left image] [B, H, W, 4], ``label`` =
    ``depth0``."""
    pair_model.eval()
    for b in batches:
        pair = b["image_pair"]
        with torch.no_grad():
            disps, _pose, _masks = pair_model(pair.permute(0, 3, 1, 2))
            coarse = resize_nearest(disps[0], pair.shape[1:3]).permute(0, 2, 3, 1)
        yield {"input": torch.cat([coarse, pair[..., :3]], -1), "label": b["depth0"]}


def train_single(args, w: LossWeights, pair: TrainState, batches: Iterator[dict]):
    """Phase 2 over DeMoN ``batches`` to ``--max_steps_single``: the pair net restored
    from the newest ``model_pairdepth`` checkpoint in ``--checkpoint_dir`` (when there is
    one), then the single net trained; returns the single net's state."""
    pair_mgr = CheckpointManager(args.checkpoint_dir, PAIR_GROUP)
    if pair_mgr.latest_step() is not None:
        pair = pair_mgr.restore(pair)
    state = single_state(args)
    mgr = CheckpointManager(args.checkpoint_dir_single, SINGLE_GROUP)
    logger = MetricLogger(args.checkpoint_dir_single)
    if args.continue_train_single and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"resumed phase 2 from step {state.step}")
    state, _ = run_training(
        state=state, train_step=make_single_depth_step(w),
        batches=single_batches(pair.model, batches), max_steps=args.max_steps_single,
        logger=logger, checkpoint=mgr, save_latest_freq=args.save_latest_freq,
        summary_freq=args.summary_freq)
    logger.close()
    return state


def main(argv=None):
    """Returns (phase-1 state, phase-2 state or None)."""
    args = parse_args(argv)
    w = loss_weights(args)
    H, W = args.image_height, args.image_width
    state = pair_state(args)
    if args.phase in ("pair", "both"):
        state = train_pair(args, w, state, demon_loader(args, H, W))
    if args.phase in ("single", "both"):
        return state, train_single(args, w, state, demon_loader(args, H, W))
    return state, None


if __name__ == "__main__":
    main()
