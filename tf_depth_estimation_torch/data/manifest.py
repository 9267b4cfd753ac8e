"""Manifest generation, the port of ``tf_depth_estimation_tpu/data/manifest.py`` (the
reference's ``setup_colon.sh``): both manifest formats, image paths one a line for
``SimpleDepthDataset`` and ``subfolder id1 id2`` lines for ``PairDepthDataset``. ::

    python -m tf_depth_estimation_torch.data.manifest --dataset_dir D --format pair
"""
from __future__ import annotations

import argparse
import os
import re
from glob import glob


def make_simple_manifest(dataset_dir: str, pattern: str = "*.jpg",
                         split: str = "train") -> str:
    """Absolute paths of the images with a label at ``<path>_z.bin``, one a line, into
    ``<split>.txt``; returns its path."""
    frames = sorted(glob(os.path.join(dataset_dir, pattern)))
    frames = [f for f in frames if os.path.exists(f + "_z.bin")]
    out = os.path.join(dataset_dir, f"{split}.txt")
    with open(out, "w") as f:
        f.write("\n".join(os.path.abspath(p) for p in frames) + "\n")
    return out


def make_pair_manifest(dataset_dir: str, split: str = "train") -> str:
    """``subfolder id1 id2`` lines for every packed-pair JPEG ``<id1>_<id2>.jpg`` one level
    under ``dataset_dir`` with its depth and camera files, into ``<split>.txt``; returns
    its path."""
    lines = []
    for sub in sorted(os.listdir(dataset_dir)):
        subdir = os.path.join(dataset_dir, sub)
        if not os.path.isdir(subdir):
            continue
        for p in sorted(glob(os.path.join(subdir, "*.jpg"))):
            m = re.match(r"^(\w+)_(\w+)\.jpg$", os.path.basename(p))
            if not m:
                continue
            id1, id2 = m.group(1), m.group(2)
            depth = os.path.join(subdir, f"frame{id1}_{id2}.jpg_z.bin")
            cam = os.path.join(subdir, f"{id1}_{id2}_cam.txt")
            if os.path.exists(depth) and os.path.exists(cam):
                lines.append(f"{sub} {id1} {id2}")
    out = os.path.join(dataset_dir, f"{split}.txt")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--format", choices=["simple", "pair"], default="pair")
    p.add_argument("--split", default="train")
    p.add_argument("--pattern", default="*.jpg")
    args = p.parse_args(argv)
    if args.format == "simple":
        out = make_simple_manifest(args.dataset_dir, args.pattern, args.split)
    else:
        out = make_pair_manifest(args.dataset_dir, args.split)
    with open(out) as f:
        n = sum(1 for _ in f)
    print(f"wrote {out} ({n} entries)")
    return out


if __name__ == "__main__":
    main()
