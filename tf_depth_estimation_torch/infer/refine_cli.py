"""Test-time refinement CLI, the port of ``tf_depth_estimation_tpu/infer/refine_cli.py``
(ref ``refine_depth.py``).

Loads a COLMAP text model, takes an image pair, derives the relative pose
(``im2.pose @ inv(im1.pose)``, ref ``refine_depth.py:325-333``) and the sparse points
tracked in the first frame, in its camera, runs ``infer.refine.refine_depth`` and writes
the scale-aligned refined depth as raw float32 ``<image1>_refined_z.bin``. Runs on the GPU
unless ``--device cpu`` is given. ::

    python -m tf_depth_estimation_torch.infer.refine_cli --model_dir sparse/0 \\
        --image_dir images --image1 a.jpg --image2 b.jpg --output_dir out [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", required=True, help="COLMAP text model dir")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--image1", required=True, help="image name as in images.txt")
    p.add_argument("--image2", required=True)
    p.add_argument("--output_dir", default="./refined")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--width", type=int, default=224)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--gt_depth_bin", default=None,
                   help="optional prior depth .bin at the working resolution")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)

    from tf_depth_estimation_torch.colmap import SceneManager
    from tf_depth_estimation_torch.infer.predictor import _load_frame
    from tf_depth_estimation_torch.infer.refine import refine_depth

    sm = SceneManager(args.model_dir).load()
    id1 = sm.name_to_image_id[args.image1]
    id2 = sm.name_to_image_id[args.image2]
    im1, im2 = sm.images[id1], sm.images[id2]
    cam = sm.cameras[im1.camera_id]

    # relative pose: world->cam2 composed with cam1->world (refine_depth.py:325-333)
    rel = im2.pose @ np.linalg.inv(im1.pose)

    # sparse anchor points: 3D points tracked in image1, in image1's camera frame
    pts3d, obs2d = sm.get_points3D(id1)
    pts_cam = (im1.R @ pts3d.T).T + im1.tvec
    sx = args.width / cam.width
    sy = args.height / cam.height
    sparse_xy = np.stack([obs2d[:, 0] * sx, obs2d[:, 1] * sy], axis=1).astype(np.float32)
    sparse_z = pts_cam[:, 2].astype(np.float32)

    K = np.array(
        [[cam.fx * sx, 0, cam.cx * sx], [0, cam.fy * sy, cam.cy * sy], [0, 0, 1]],
        np.float32,
    )
    img1 = _load_frame(os.path.join(args.image_dir, args.image1), args.height, args.width)
    img2 = _load_frame(os.path.join(args.image_dir, args.image2), args.height, args.width)

    gt = None
    if args.gt_depth_bin:
        gt = np.fromfile(args.gt_depth_bin, np.float32).reshape(args.height, args.width)

    depth, hist = refine_depth(
        img1, img2, rel.astype(np.float32), K, sparse_xy, sparse_z,
        gt_depth=gt, steps=args.steps, learning_rate=args.learning_rate,
        device=args.device,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, args.image1 + "_refined_z.bin")
    depth.astype(np.float32).tofile(out)
    print(f"wrote {out}; loss history {hist['loss']}; scale history {hist['scale']}")
    return depth, hist


if __name__ == "__main__":
    main()
