"""Synthetic colon pairs and DeMoN scenes in the reference's on-disk formats (port of the
v1 scene family of ``tf_depth_estimation_tpu/data/synthetic.py``).

A textured image with a smooth depth surface, a small known pose and a source view shifted
to match; the losses only need the geometry to be consistent, which the GT warp
re-derives. The JAX package's "rich" scene family is not ported.
"""
from __future__ import annotations

import os

import numpy as np


def _texture(rng, H, W):
    """Smooth random texture in [0, 255]."""
    base = rng.rand(H // 8 + 2, W // 8 + 2, 3)
    img = np.kron(base, np.ones((8, 8, 1)))[:H, :W]
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = img * 0.7 + 0.3 * np.stack(
        [np.sin(xx / 9.0) * 0.5 + 0.5, np.cos(yy / 7.0) * 0.5 + 0.5, (xx + yy) % 32 / 32.0],
        axis=-1)
    return (img * 255).astype(np.float32)


def _depth_surface(rng, H, W, near=0.8, far=2.5):
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    bumps = sum(
        a * np.sin(2 * np.pi * (fx * xx + fy * yy + ph))
        for a, fx, fy, ph in zip(rng.uniform(0.02, 0.08, 4), rng.randint(1, 4, 4),
                                 rng.randint(1, 4, 4), rng.rand(4)))
    d = near + (far - near) * (0.5 + 0.3 * (xx - 0.5) + 0.2 * (yy - 0.5) + bumps)
    return np.clip(d, near * 0.5, far * 1.5).astype(np.float32)


def _rotvec_to_matrix_np(v: np.ndarray) -> np.ndarray:
    """Rodrigues' formula, float64."""
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3, dtype=np.float64)
    a = v / angle
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def make_pair_scene(rng, H, W, fx=None, fy=None):
    """(tgt [H,W,3], src [H,W,3], depth [H,W], K [3,3], pose6 [t | rotvec]) float32."""
    fx = fx or 0.9 * W
    fy = fy or 0.9 * W
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    tgt = _texture(rng, H, W)
    depth = _depth_surface(rng, H, W)
    pose6 = np.array(
        [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(-0.02, 0.02),
         rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02)],
        np.float32)
    src = np.roll(tgt, shift=(int(pose6[1] * fy / depth.mean()),
                              int(pose6[0] * fx / depth.mean())), axis=(0, 1))
    return tgt, src, depth, K, pose6


def pose_matrix(pose6: np.ndarray) -> np.ndarray:
    """[4, 4] float32 transform from [t | rotvec]."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _rotvec_to_matrix_np(pose6[3:].astype(np.float64)).astype(np.float32)
    T[:3, 3] = pose6[:3]
    return T


def write_colon_pair_dataset(root: str, num_frames: int = 8, H: int = 240, W: int = 720,
                             splits=("train", "val"), seed: int = 0):
    """Write the ``imageselect_Dataloader_optflow.py`` layout: ``<split>.txt`` lines
    ``sub id1 id2``; the packed pair JPEG (width 2x, quality 95); ``frame<ids>.jpg_z.bin``
    raw float32; ``_cam.txt`` 3x3 CSV; ``_tgt2src_proj.txt`` 34 values."""
    import cv2

    rng = np.random.RandomState(seed)
    sub = "seq0"
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    per_split = {s: [] for s in splits}
    for i in range(num_frames):
        tgt, src, depth, K, pose6 = make_pair_scene(rng, H, W)
        id1, id2 = f"{i:04d}", f"{i+1:04d}"
        frame = f"{id1}_{id2}"
        packed = np.concatenate([tgt, src], axis=1)
        cv2.imwrite(os.path.join(root, sub, frame + ".jpg"),
                    packed[..., ::-1].astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 95])
        depth.astype(np.float32).tofile(
            os.path.join(root, sub, "frame" + frame + ".jpg" + "_z.bin"))
        with open(os.path.join(root, sub, frame + "_cam.txt"), "w") as f:
            f.write(",".join(str(float(v)) for v in K.reshape(-1)))
        T = pose_matrix(pose6)
        vals = list(T.reshape(-1)) + list(np.linalg.inv(T).reshape(-1)) + [1.0, 0.0]
        with open(os.path.join(root, sub, frame + "_tgt2src_proj.txt"), "w") as f:
            f.write(" ".join(str(float(v)) for v in vals))
        per_split[splits[i % len(splits)]].append(f"{sub} {id1} {id2}")
    for s, lines in per_split.items():
        with open(os.path.join(root, f"{s}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def demon_record(rng, H: int, W: int):
    """One raw DeMoN record of a ``make_pair_scene`` scene, as ``write_demon_h5`` stores it:
    (``image_pair`` uint8 [H, W, 6], ``depth`` float32 [H, W], ``motion`` float32 [6]
    [rotation vector | translation], ``intrinsics`` float32 [4] normalised fx fy cx cy)."""
    tgt, src, depth, K, pose6 = make_pair_scene(rng, H, W)
    pair = np.concatenate([tgt, src], axis=-1).astype(np.uint8)
    motion = np.concatenate([pose6[3:], pose6[:3]]).astype(np.float32)
    intr = np.array([K[0, 0] / W, K[1, 1] / H, K[0, 2] / W, K[1, 2] / H], np.float32)
    return pair, depth, motion, intr


def write_demon_h5(path: str, num_scenes: int = 8, H: int = 192, W: int = 256,
                   seed: int = 0) -> str:
    """Write the flat DeMoN HDF5 schema that ``data/demon.py:DemonDataset`` reads: groups
    ``scene0000``.. with ``image_pair``, ``depth`` (gzip), ``motion`` and
    ``intrinsics``."""
    import h5py

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for i in range(num_scenes):
            pair, depth, motion, intr = demon_record(rng, H, W)
            g = f.create_group(f"scene{i:04d}")
            g.create_dataset("image_pair", data=pair, compression="gzip")
            g.create_dataset("depth", data=depth, compression="gzip")
            g.create_dataset("motion", data=motion)
            g.create_dataset("intrinsics", data=intr)
    return path
