"""Batch-prediction CLI (ref ``batch_prediction.py`` / ``batch_prediction_cam_est.py``).

``python -m tf_depth_estimation_torch.infer.cli --dataset_dir D --output_dir O
(--weights W.npz | --checkpoint_dir C [--checkpoint_group G]) [--mode depth|pair|turbo]
[--turbo_variant base] [--device cuda]`` globs ``D/*.jpg`` and writes ``<name>_z.bin``
float32 depth dumps, and in pair mode ``<frame>.txt`` poses beside the frames, with the
flags of ``tf_depth_estimation_tpu/infer/cli.py``. Depth mode serves depth4 DispNet, pair
mode the truncated DepthPoseNet (JAX ``infer/cli.py:70-71``), turbo mode a TurboDepthNet
student of ``--turbo_variant``, which the ``.npz``'s ``variant`` metadata overrides (the
committed ``weights/turbo_*.npz`` carry it). ``--checkpoint_dir`` serves the newest
``<group>-<step>.npz`` that the port's trainers write there: group ``turbo`` by default in
turbo mode (``distill_turbo.py``), ``model`` otherwise (``depth_only.py``; pass
``--checkpoint_group model`` for a ``depth_only --turbo`` run). The JAX package's orbax
directories are not read.
"""
from __future__ import annotations

import argparse

import torch

from tf_depth_estimation_torch.infer.predictor import (
    DepthPredictor,
    PairPredictor,
    TurboPredictor,
)
from tf_depth_estimation_torch.models.dispnet import DispNet
from tf_depth_estimation_torch.models.turbo import TurboVariant
from tf_depth_estimation_torch.train.checkpoint import load_latest_variables
from tf_depth_estimation_torch.utils.npz import load_variables_npz
from tf_depth_estimation_torch.weights import (
    depth_pose_from_variables,
    load_variables,
    turbo_from_variables,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint_dir", default="",
                   help="a training run's checkpoint directory (this or --weights)")
    p.add_argument("--weights", default="",
                   help="flat .npz serving weights. If its metadata names a turbo "
                        "variant, it overrides --turbo_variant.")
    p.add_argument("--checkpoint_group", default=None,
                   help="checkpoint group (default: 'model'; 'turbo' in turbo mode; pass "
                        "'model' for a depth_only --turbo run)")
    p.add_argument("--mode", choices=["depth", "pair", "turbo"], default="depth",
                   help="'turbo' serves a TurboDepthNet student; combine with "
                        "--turbo_variant")
    p.add_argument("--turbo_variant", default="base")
    p.add_argument("--image_height", type=int, default=224,
                   help="network input height (ref batch_prediction.py: 224)")
    p.add_argument("--image_width", type=int, default=224)
    p.add_argument("--out_height", type=int, default=240,
                   help="output .bin resolution (ref: 240x720)")
    p.add_argument("--out_width", type=int, default=720)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--no_bilateral", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)
    if bool(args.checkpoint_dir) == bool(args.weights):
        p.error("pass exactly one of --checkpoint_dir / --weights")

    if args.weights:
        source = args.weights
        variables, meta = load_variables_npz(args.weights)
    else:
        if args.checkpoint_group is None:
            args.checkpoint_group = "turbo" if args.mode == "turbo" else "model"
        variables, step = load_latest_variables(args.checkpoint_dir, args.checkpoint_group)
        source, meta = f"{args.checkpoint_group}-{step}.npz in {args.checkpoint_dir}", {}
    kwargs = {}
    # check the tree against the mode's model here, naming the file, rather than deep
    # inside the forward
    if args.mode == "turbo":
        if meta.get("variant"):
            args.turbo_variant = meta["variant"]
        variant = TurboVariant.by_name(args.turbo_variant)
        try:
            turbo_from_variables(variables, variant, device="cpu")
        except (KeyError, RuntimeError):
            raise SystemExit(
                f"{source} does not match variant {args.turbo_variant!r}: its "
                f"parameter tree differs from the model's. If this is a turbo .npz "
                f"without 'variant' metadata, pass the matching --turbo_variant.")
        cls, kwargs = TurboPredictor, {"variant": variant}
    elif args.mode == "depth":
        try:
            load_variables(DispNet(), variables)
        except (KeyError, RuntimeError) as e:
            raise SystemExit(f"{source} does not hold depth4 DispNet weights: {e}")
        cls = DepthPredictor
    else:
        try:
            full = depth_pose_from_variables(variables, device="cpu").full_resolution
        except (KeyError, RuntimeError) as e:
            raise SystemExit(f"{source} does not hold DepthPoseNet weights: {e}")
        if full:
            raise SystemExit(f"{source} holds the full-resolution DepthPoseNet; "
                             f"pair mode serves the truncated one")
        cls = PairPredictor
    pred = cls(variables["params"], variables["batch_stats"], height=args.image_height,
               width=args.image_width, batch_size=args.batch_size,
               dtype=getattr(torch, args.dtype), device=args.device, **kwargs)
    written = pred.predict_directory(
        args.dataset_dir, args.output_dir, out_height=args.out_height,
        out_width=args.out_width, bilateral=not args.no_bilateral)
    print(f"wrote {len(written)} depth maps to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
