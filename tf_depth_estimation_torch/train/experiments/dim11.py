"""Joint depth and pose on 224x224 colon pairs (ref ``train_depth_only_dim11.py``).

The full-resolution DepthPoseNet on the dim11 loader's pairs (pixels in [-0.5, 0.5],
``data/colon.py:Dim11Dataset``), batch 10: per scale the depth L1, the smoothness of the
raw prediction and the explainability-weighted photometric L1 of the source warped with
the predicted Euler pose (``dim11_joint_loss``); the intrinsics pyramid is built from the
cam files' fx fy cx cy. On the GPU a step's smoothness terms run ``csrc/smoothness.cu``
and its 4 warps the sampler kernels (``csrc/bilinear_sample.cu``) once each way. ::

    python -m tf_depth_estimation_torch.train.experiments.dim11 --dataset_dir D \\
        [--depth_dir DD] --checkpoint_dir C [--device cpu] [--dtype float32]

``D`` holds the packed-pair layout with 6-value ``_cam.txt`` files; ``--depth_dir`` the
``frame<ids>.jpg_z.bin`` depths where they are not beside the pairs. Writes
``C/metrics.jsonl`` and ``C/model-<step>.npz`` (+ ``.opt.pt``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from tf_depth_estimation_torch.data.colon import Dim11Dataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader, device_prefetch
from tf_depth_estimation_torch.geometry.camera import (
    make_intrinsics_matrix,
    scale_intrinsics_pyramid,
)
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    parse,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import make_dim11_step


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=10, max_steps=200000)
    p.add_argument("--image_height", type=int, default=224)
    p.add_argument("--image_width", type=int, default=224)
    p.add_argument("--depth_dir", default=None)
    return parse(p, argv)


def loss_weights(args) -> LossWeights:
    """``LossWeights.dim11`` at the run's size and step count."""
    return dataclasses.replace(LossWeights.dim11(), height=args.image_height,
                               width=args.image_width, max_steps=args.max_steps)


def make_state(args) -> TrainState:
    """The full-resolution DepthPoseNet (seeded init) and Adam at the constant rate."""
    model = DepthPoseNet(full_resolution=True,
                         generator=torch.Generator().manual_seed(args.seed),
                         dtype=compute_dtype(args)).to(args.device)
    return create_train_state(model, learning_rate=args.learning_rate, beta1=args.beta1)


def make_step(args, w: LossWeights):
    return make_dim11_step(w)


def with_intrinsics(batches: Iterator[dict]) -> Iterator[dict]:
    """Host batches with ``cam`` (6 raw values: fx fy cx cy and 2 unused) replaced by the
    4-scale ``intrinsics`` pyramid [B, 4, 3, 3]."""
    for b in batches:
        fx, fy, cx, cy = torch.from_numpy(b.pop("cam")[:, :4]).unbind(-1)
        b["intrinsics"] = scale_intrinsics_pyramid(
            make_intrinsics_matrix(fx, fy, cx, cy), 4).numpy()
        yield b


def batches(args) -> Iterator[dict]:
    """Shuffled dim11 batches of the train split on ``args.device``, two in flight."""
    ds = Dim11Dataset(args.dataset_dir, split="train", image_height=args.image_height,
                      image_width=args.image_width, resized_height=args.image_height,
                      resized_width=args.image_width, depth_dir=args.depth_dir)
    loader = BatchLoader(ds, args.batch_size, seed=args.seed, num_epochs=args.num_epochs)
    return device_prefetch(with_intrinsics(iter(loader)), args.device)


def train(args, w: LossWeights, state: TrainState, batches: Iterator[dict]):
    """dim11 over ``batches`` to ``--max_steps``; returns (state, the last logged
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
