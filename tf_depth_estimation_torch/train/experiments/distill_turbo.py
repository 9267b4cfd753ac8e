"""Distil a trained depth4 DispNet into a TurboDepthNet student (the port of
``tf_depth_estimation_tpu/train/experiments/distill_turbo.py``).

The teacher is a depth4 checkpoint (e.g. from ``experiments/depth_only.py``); the student
learns its whole 4-scale disparity pyramid on unlabeled frames (``train/distill.py``). The
teacher's frozen eval forward is the serving forward, BN folded, whose decoder tail runs
the fused CUDA kernel (``ops/fused_tail.py``) on the GPU. ::

    python -m tf_depth_estimation_torch.train.experiments.distill_turbo \\
        --teacher_checkpoint_dir C_depth --frames_glob '/data/frames/*.jpg' \\
        --turbo_variant base --checkpoint_dir C_turbo [--device cpu] [--dtype float32]

Without ``--frames_glob`` it distils on 16 seeded synthetic textures; without
``--teacher_checkpoint_dir`` the teacher is a seeded depth4 init with the init's running
statistics, as in the JAX package (a pipeline check: a real run needs a trained teacher).
``--teacher_checkpoint_dir`` reads the newest ``model-<step>.npz`` there. Writes
``C_turbo/metrics.jsonl`` (``"train"`` and ``"val"`` records: ``mae_vs_teacher``,
``absrel_vs_teacher``) and ``C_turbo/turbo-<step>.npz`` (+ ``.opt.pt``), which
``infer/cli.py --mode turbo --checkpoint_dir C_turbo`` serves.
"""
from __future__ import annotations

import glob

import numpy as np
import torch

from tf_depth_estimation_torch.data.synthetic import _texture
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.train.checkpoint import load_latest_variables
from tf_depth_estimation_torch.train.distill import (
    folded_teacher,
    make_distill_eval,
    make_distill_step,
)
from tf_depth_estimation_torch.train.experiments.common import (
    base_parser,
    compute_dtype,
    parse,
    setup_run,
)
from tf_depth_estimation_torch.train.loop import run_training
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.weights import load_variables, state_dict_to_variables

_CACHE_FRAMES = 1024  # ~2.5 MB a frame at 384x576: at most ~2.5 GB of host memory
SYNTHETIC_FRAMES = 16


def _frame_batches(args, H: int, W: int):
    """Endless ``{"image": [B, H, W, 3] float32}`` batches on ``args.device`` in the
    serving input range (raw 0..255, as ``infer/predictor.py`` feeds frames), the JAX
    package's batches bit for bit: one ``RandomState(args.seed)`` draws the synthetic
    frames, then each batch's indices, mirror-x bits and rot180 bits (p = 0.5 each, off
    under ``--no_aug``). ``--frames_glob`` frames are decoded at first use with PIL,
    resized with its BILINEAR filter, and the first ``_CACHE_FRAMES`` kept."""

    def aug(batch, rng):
        if not args.aug:
            return batch
        flip = rng.rand(len(batch)) < 0.5
        rot = rng.rand(len(batch)) < 0.5
        batch = np.where(flip[:, None, None, None], batch[:, :, ::-1], batch)
        return np.where(rot[:, None, None, None], batch[:, ::-1, ::-1], batch)

    def out(batch):
        return {"image": torch.from_numpy(np.ascontiguousarray(batch)).to(args.device)}

    rng = np.random.RandomState(args.seed)
    if args.frames_glob:
        paths = sorted(glob.glob(args.frames_glob))
        if not paths:
            raise FileNotFoundError(f"--frames_glob {args.frames_glob!r} matched no files")
        from PIL import Image

        cache = {}

        def load(p):
            got = cache.get(p)
            if got is None:
                im = Image.open(p).convert("RGB").resize((W, H), Image.BILINEAR)
                got = np.asarray(im, np.float32)
                if len(cache) < _CACHE_FRAMES:
                    cache[p] = got
            return got

        while True:
            idx = rng.randint(0, len(paths), size=args.batch_size)
            yield out(aug(np.stack([load(paths[i]) for i in idx]), rng))
    else:
        frames = np.stack([_texture(rng, H, W) for _ in range(SYNTHETIC_FRAMES)])
        frames = frames.astype(np.float32)
        while True:
            idx = rng.randint(0, len(frames), size=args.batch_size)
            yield out(aug(frames[idx], rng))


def load_teacher_variables(args) -> dict:
    """The depth4 teacher's variables tree: the newest ``model-<step>.npz`` of
    ``--teacher_checkpoint_dir``, else a seeded init (``args.seed + 1``)."""
    if not args.teacher_checkpoint_dir:
        model = DispNet(DispNetVariant.depth4(),
                        generator=torch.Generator().manual_seed(args.seed + 1))
        return state_dict_to_variables(model.state_dict())
    variables, step = load_latest_variables(args.teacher_checkpoint_dir, "model")
    try:
        load_variables(DispNet(), variables)
    except (KeyError, RuntimeError) as e:
        raise SystemExit(f"model-{step}.npz in {args.teacher_checkpoint_dir} does not hold "
                         f"depth4 DispNet weights: {e}")
    print(f"teacher restored from step {step}")
    return variables


def parse_args(argv=None):
    p = base_parser(__doc__, batch_size=8, max_steps=5000)
    p.set_defaults(save_latest_freq=500)
    p.add_argument("--teacher_checkpoint_dir", default="",
                   help="depth4 checkpoint directory (e.g. a depth_only.py run)")
    p.add_argument("--frames_glob", default="",
                   help="unlabeled training frames; default: synthetic textures")
    p.add_argument("--turbo_variant", default="base", choices=list(TurboVariant.PRESETS))
    p.add_argument("--image_height", type=int, default=384)
    p.add_argument("--image_width", type=int, default=576)
    p.add_argument("--no_aug", dest="aug", action="store_false",
                   help="turn off the mirror-x / rot180 input augmentation")
    args = parse(p, argv)
    try:
        TurboVariant.by_name(args.turbo_variant).check_size(args.image_height,
                                                            args.image_width)
    except ValueError as e:
        p.error(str(e))
    return args


def main(argv=None):
    args = parse_args(argv)
    H, W = args.image_height, args.image_width
    dtype = compute_dtype(args)
    teacher = folded_teacher(load_teacher_variables(args), dtype=dtype, device=args.device)
    student = TurboDepthNet(TurboVariant.by_name(args.turbo_variant),
                            generator=torch.Generator().manual_seed(args.seed), dtype=dtype)
    state = create_train_state(student.to(args.device), learning_rate=args.learning_rate,
                               beta1=args.beta1)
    mgr, logger, state = setup_run(args, state, group="turbo")
    step = make_distill_step(teacher)
    evaluate = make_distill_eval(teacher)
    batches = _frame_batches(args, H, W)
    state, last = run_training(
        state=state, train_step=lambda st, batch: step(st, batch["image"]),
        batches=batches, max_steps=args.max_steps, logger=logger, checkpoint=mgr,
        save_latest_freq=args.save_latest_freq, summary_freq=args.summary_freq,
        validation_check=args.validation_check,
        val_fn=lambda st: evaluate(st, next(batches)["image"]))
    logger.close()
    return state, last


if __name__ == "__main__":
    main()
