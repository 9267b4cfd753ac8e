"""Shared plumbing for the experiment CLIs of the PyTorch port."""
from __future__ import annotations

import argparse
import glob
import os

import torch

from tf_depth_estimation_torch.data.demon import DemonDataset, DemonReaderParams
from tf_depth_estimation_torch.data.demon_v1 import DemonV1Dataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader, StreamLoader, device_prefetch
from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.loop import MetricLogger

# flags of the JAX CLIs that later slices bring; the port refuses them rather than
# ignoring them
NOT_PORTED = {
    "native_loader": "the C++ loader (native/) is bound by a later slice",
    "tensorboard": "TensorBoard summaries are not ported; metrics go to metrics.jsonl",
    "rich_summaries": "image and histogram summaries are not ported",
}


def base_parser(description: str, batch_size: int, max_steps: int) -> argparse.ArgumentParser:
    """The flags of ``tf_depth_estimation_tpu/train/experiments/common.py``, with its types
    and defaults, plus ``--device``. Those of later slices are refused (``NOT_PORTED``);
    ``--validate_dir`` and ``--init_checkpoint_file`` are accepted and unread, as in
    JAX, and ``--image_summary_freq`` and ``--fixture_images`` are read there only under
    ``--rich_summaries``. ``--demon_v1`` is read by ``demon_loader``; the CLIs that read
    no DeMoN data accept it unread, as in JAX."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--validate_dir", default="./validation")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=batch_size)
    p.add_argument("--max_steps", type=int, default=max_steps)
    p.add_argument("--save_latest_freq", type=int, default=1000)
    p.add_argument("--validation_check", type=int, default=100)
    p.add_argument("--summary_freq", type=int, default=100)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--init_checkpoint_file", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num_epochs", type=int, default=1500)
    p.add_argument("--image_summary_freq", type=int, default=500)
    p.add_argument("--fixture_images", default=None)
    p.add_argument("--demon_v1", action="store_true",
                   help="stream classic DeMoN v1 HDF5 archives in place "
                        "(sun3d/rgbd/mvs/scenes11 as released) instead of the flat schema")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    for flag, why in NOT_PORTED.items():
        p.add_argument(f"--{flag}", action="store_true", help=f"not ported: {why}")
    return p


def parse(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    args = p.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            p.error(f"--{flag} is not ported to tf_depth_estimation_torch yet: {why}")
    return args


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def pair_loader(args, ds, batch_size: int):
    """Shuffled colon pair-dataset batches on ``args.device``, two in flight."""
    loader = BatchLoader(ds, batch_size, seed=args.seed, num_epochs=args.num_epochs)
    return device_prefetch(iter(loader), args.device)


def demon_sources(dataset_dir: str):
    """Weighted HDF5 sources of ``Demon_Data_loader.py:69-74``; any ``*.h5`` of weight 1
    when none of the reference's files is there (synthetic or converted data)."""
    pats = [("sun3d_train*.h5", 0.8), ("rgbd_*_train.h5", 0.2), ("mvs_breisach.h5", 0.3),
            ("mvs_citywall.h5", 0.3), ("scenes11_train.h5", 0.2)]
    sources = [(path, wgt) for pat, wgt in pats
               for path in sorted(glob.glob(os.path.join(dataset_dir, pat)))]
    if not sources:
        sources = [(p, 1.0) for p in sorted(glob.glob(os.path.join(dataset_dir, "*.h5")))]
    if not sources:
        raise FileNotFoundError(f"no HDF5 sources under {dataset_dir}")
    return sources


def demon_loader(args, height: int, width: int, test_phase: bool = False):
    """DeMoN batches on ``args.device``, two in flight: the scene-pool stream of
    ``StreamLoader`` for training, the sources in order for the test phase. The test
    phase reads with one worker: with two, as the JAX package reads it, whichever batch a
    worker finishes first comes first, so an evaluation could average one batch twice and
    skip the next (ROADMAP Queue 3 #4). ``--demon_v1`` reads classic v1 archives in place
    (``DemonV1Dataset``)."""
    params = DemonReaderParams(batch_size=args.batch_size, scaled_height=height,
                               scaled_width=width, test_phase=test_phase)
    cls = DemonV1Dataset if getattr(args, "demon_v1", False) else DemonDataset
    ds = cls(demon_sources(args.dataset_dir), params, seed=args.seed)
    if test_phase:
        loader = BatchLoader(ds, args.batch_size, seed=args.seed, shuffle=False,
                             num_workers=1)
    else:
        loader = StreamLoader(ds, args.batch_size, seed=args.seed)
    return device_prefetch(iter(loader), args.device)


def setup_run(args, state, group: str = "model"):
    """Checkpoint manager of ``group`` + logger, and the resume of ``--continue_train``."""
    mgr = CheckpointManager(args.checkpoint_dir, group)
    logger = MetricLogger(args.checkpoint_dir)
    if args.continue_train and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}")
    return mgr, logger, state
