"""Shared plumbing for the experiment CLIs of the PyTorch port."""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from tf_depth_estimation_torch.data.demon import DemonDataset, DemonReaderParams
from tf_depth_estimation_torch.data.demon_v1 import DemonV1Dataset
from tf_depth_estimation_torch.data.pipeline import (
    BatchLoader,
    IterBatcher,
    StreamLoader,
    device_prefetch,
)
from tf_depth_estimation_torch.data.synthetic import _texture
from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.loop import MetricLogger


def base_parser(description: str, batch_size: int, max_steps: int) -> argparse.ArgumentParser:
    """The flags of ``tf_depth_estimation_tpu/train/experiments/common.py``, with its types
    and defaults, plus ``--device``. ``--validate_dir`` and ``--init_checkpoint_file`` are
    accepted and unread, as in JAX; ``--image_summary_freq`` and ``--fixture_images`` are
    read under ``--rich_summaries`` by the CLIs that make image summaries (depth_only,
    optflow_combine, split_training's phase 1), and the others accept them unread, as in
    JAX. ``--demon_v1`` is read by ``demon_loader`` and ``--native_loader`` by
    ``pair_loader``; the CLIs that read no such data accept them unread, as in JAX."""
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
    p.add_argument("--native_loader", action="store_true",
                   help="decode the colon pairs' JPEG and depth through the C++ loader "
                        "(native/fastloader.cc, built with g++ at first use)")
    p.add_argument("--demon_v1", action="store_true",
                   help="stream classic DeMoN v1 HDF5 archives in place "
                        "(sun3d/rgbd/mvs/scenes11 as released) instead of the flat schema")
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror metrics to TensorBoard event files under "
                        "<checkpoint_dir>/sum (needs the tensorboard package)")
    p.add_argument("--rich_summaries", action="store_true",
                   help="per-scale image and histogram summaries and the fixed-fixture "
                        "inference (ref split_training.py:283-325,380-393); implies "
                        "--tensorboard")
    p.add_argument("--image_summary_freq", type=int, default=500)
    p.add_argument("--fixture_images", default=None,
                   help="two comma-separated image paths for the fixture inference (the "
                        "reference's sculpture pair); default: a seeded synthetic pair")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def pair_loader(args, ds, batch_size: int):
    """Shuffled colon pair-dataset batches on ``args.device``, two in flight.
    ``--native_loader``
    decodes through the C++ loader's worker threads (``data/native.py``: the JPEG, the
    TF1 resize and the raw depth), batched by ``IterBatcher``, the analog of the
    reference's TF queue-runner threads (``imageselect_Dataloader_optflow.py:41-56``);
    where the loader cannot build it raises, as JAX does, and never falls back."""
    if args.native_loader:
        from tf_depth_estimation_torch.data import native

        if not native.available():
            raise RuntimeError(f"--native_loader needs the C++ loader: "
                               f"{native.build_error()}")
        sampler = native.NativePairSampler(ds, seed=args.seed)
        loader = IterBatcher(lambda: iter(sampler), batch_size, num_epochs=args.num_epochs)
    else:
        loader = BatchLoader(ds, batch_size, seed=args.seed, num_epochs=args.num_epochs)
    return device_prefetch(iter(loader), args.device)


def fixture_pair(args, H: int, W: int) -> np.ndarray:
    """[1, H, W, 6] float32 fixture pair in DeMoN's normalisation (/255 - 0.5, ref
    ``split_training.py:386-388``): the two images of ``--fixture_images`` (the
    reference's sculpture pair; PIL, Lanczos resize) or a seeded synthetic texture and
    its copy shifted 3 pixels right, as the JAX package makes it."""
    if args.fixture_images:
        from PIL import Image

        paths = args.fixture_images.split(",")
        if len(paths) != 2:
            raise ValueError("--fixture_images needs exactly two comma-separated paths")
        imgs = [np.asarray(Image.open(p).convert("RGB").resize((W, H), Image.LANCZOS),
                           np.float32) for p in paths]
        pair = np.concatenate([im / 255.0 - 0.5 for im in imgs], axis=-1)
    else:
        left = _texture(np.random.RandomState(1234), H, W)
        right = np.roll(left, 3, axis=1)  # a small horizontal parallax
        pair = np.concatenate([left / 255.0 - 0.5, right / 255.0 - 0.5], axis=-1)
    return pair[np.newaxis].astype(np.float32)


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
    """Checkpoint manager of ``group`` + logger (mirrored to TensorBoard under
    ``--tensorboard`` or ``--rich_summaries``), and the resume of ``--continue_train``."""
    mgr = CheckpointManager(args.checkpoint_dir, group)
    logger = MetricLogger(args.checkpoint_dir,
                          tensorboard=args.tensorboard or args.rich_summaries)
    if args.continue_train and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}")
    return mgr, logger, state
