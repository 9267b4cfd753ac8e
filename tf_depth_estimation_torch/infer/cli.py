"""Batch-prediction CLI, depth mode (ref ``batch_prediction.py``).

``python -m tf_depth_estimation_torch.infer.cli --dataset_dir D --output_dir O
--weights W.npz [--device cuda]`` globs ``D/*.jpg`` and writes ``<name>_z.bin`` float32
depth dumps, with the flags of ``tf_depth_estimation_tpu/infer/cli.py`` for that mode.
Orbax checkpoint directories and the pair and turbo modes come with later slices.
"""
from __future__ import annotations

import argparse

import torch

from tf_depth_estimation_torch.infer.predictor import DepthPredictor
from tf_depth_estimation_torch.models.dispnet import DispNet
from tf_depth_estimation_torch.utils.npz import load_variables_npz
from tf_depth_estimation_torch.weights import variables_to_state_dict


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--weights", required=True, help="flat .npz serving weights")
    p.add_argument("--mode", choices=["depth"], default="depth")
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

    variables, _meta = load_variables_npz(args.weights)
    try:  # fail here, naming the file, rather than deep inside the forward
        DispNet().load_state_dict(variables_to_state_dict(variables), strict=True)
    except (KeyError, RuntimeError) as e:
        raise SystemExit(f"{args.weights} does not hold depth4 DispNet weights: {e}")
    pred = DepthPredictor(
        variables["params"], variables["batch_stats"], height=args.image_height,
        width=args.image_width, batch_size=args.batch_size,
        dtype=getattr(torch, args.dtype), device=args.device)
    written = pred.predict_directory(
        args.dataset_dir, args.output_dir, out_height=args.out_height,
        out_width=args.out_width, bilateral=not args.no_bilateral)
    print(f"wrote {len(written)} depth maps to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
