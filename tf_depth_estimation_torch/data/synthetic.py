"""Synthetic colon pairs, single images, DeMoN scenes and two-view COLMAP models in the
reference's on-disk formats (port of ``tf_depth_estimation_tpu/data/synthetic.py``).

A textured image with a smooth depth surface, a small known pose and a source view shifted
to match; the losses only need the geometry to be consistent, which the GT warp
re-derives. Both scene families of the JAX package: ``"v1"`` (image and depth drawn
independently) and ``"rich"`` (a lumen-tube depth, randomised texture and ramps, and a
1/d^2 illumination that ties the image to the depth). Every draw comes from one
``RandomState`` in the JAX package's order, so a seed gives the same scenes there and
here. ``write_colmap_pair`` (the port's own) writes a two-view COLMAP text model of one
scene for ``infer/refine_cli.py``.
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


def _texture_rich(rng, H, W):
    """Multi-scale texture with randomized block size, contrast, and hue balance."""
    block = int(rng.choice([4, 8, 16]))
    base = rng.rand(H // block + 2, W // block + 2, 3)
    img = np.kron(base, np.ones((block, block, 1)))[:H, :W]
    fine = rng.rand(H // 2 + 1, W // 2 + 1, 3)
    img = 0.75 * img + 0.25 * np.kron(fine, np.ones((2, 2, 1)))[:H, :W]
    contrast = rng.uniform(0.4, 1.0)
    tint = rng.uniform(0.6, 1.0, size=(1, 1, 3))
    img = (0.5 + contrast * (img - 0.5)) * tint
    return np.clip(img * 255.0, 0, 255).astype(np.float32)


def _depth_surface_rich(rng, H, W, near=0.5, far=3.5):
    """Tube-like depth (a random lumen point the scene recedes toward), a ramp of random
    direction and multi-scale bumps: all three vary scene to scene."""
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    cx, cy = rng.uniform(0.25, 0.75, 2)
    aspect = W / H
    r = np.sqrt(((xx - cx) * aspect) ** 2 + (yy - cy) ** 2)
    lumen = rng.uniform(0.3, 0.9) * np.exp(-(r / rng.uniform(0.3, 0.7)) ** 2)
    theta = rng.uniform(0, 2 * np.pi)
    ramp = rng.uniform(0.0, 0.3) * ((xx - 0.5) * np.cos(theta) + (yy - 0.5) * np.sin(theta))
    n_bumps = rng.randint(3, 7)
    bumps = sum(
        a * np.sin(2 * np.pi * (fx_ * xx + fy_ * yy + ph))
        for a, fx_, fy_, ph in zip(rng.uniform(0.01, 0.07, n_bumps),
                                   rng.randint(1, 7, n_bumps), rng.randint(1, 7, n_bumps),
                                   rng.rand(n_bumps)))
    d = near + (far - near) * (0.25 + lumen + ramp + bumps)
    return np.clip(d, near, far).astype(np.float32)


def _shade_by_depth(rng, tex, depth):
    """Endoscope-style illumination: a point light at the camera gives irradiance ~
    1/d^2, times a soft depth-gradient shading term, so the image carries the depth."""
    falloff = (1.0 / np.maximum(depth, 0.2)) ** rng.uniform(1.5, 2.2)
    falloff = falloff / falloff.max()
    gy, gx = np.gradient(depth)
    grad_mag = np.sqrt(gx * gx + gy * gy)
    shade = 1.0 / (1.0 + rng.uniform(20.0, 80.0) * grad_mag)
    illum = np.clip(falloff * shade, 0.02, 1.0)[..., None]
    gamma = rng.uniform(0.8, 1.1)
    return np.clip(255.0 * (tex / 255.0 * illum) ** gamma, 0, 255).astype(np.float32)


def _rotvec_to_matrix_np(v: np.ndarray) -> np.ndarray:
    """Rodrigues' formula, float64."""
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3, dtype=np.float64)
    a = v / angle
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def make_pair_scene(rng, H, W, fx=None, fy=None, family: str = "v1"):
    """(tgt [H,W,3], src [H,W,3], depth [H,W], K [3,3], pose6 [t | rotvec]) float32 of
    the scene ``family``, ``"v1"`` or ``"rich"``."""
    fx = fx or 0.9 * W
    fy = fy or 0.9 * W
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    if family == "rich":
        depth = _depth_surface_rich(rng, H, W)
        tgt = _shade_by_depth(rng, _texture_rich(rng, H, W), depth)
    elif family == "v1":
        tgt = _texture(rng, H, W)
        depth = _depth_surface(rng, H, W)
    else:
        raise ValueError(f"unknown scene family: {family!r}")
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
                             splits=("train", "val"), seed: int = 0, family: str = "v1"):
    """Write the ``imageselect_Dataloader_optflow.py`` layout: ``<split>.txt`` lines
    ``sub id1 id2``; the packed pair JPEG (width 2x, quality 95); ``frame<ids>.jpg_z.bin``
    raw float32; ``_cam.txt`` 3x3 CSV; ``_tgt2src_proj.txt`` 34 values."""
    import cv2

    rng = np.random.RandomState(seed)
    sub = "seq0"
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    per_split = {s: [] for s in splits}
    for i in range(num_frames):
        tgt, src, depth, K, pose6 = make_pair_scene(rng, H, W, family=family)
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


def write_simple_depth_dataset(root: str, num_frames: int = 6, H: int = 224, W: int = 224,
                               split: str = "train", seed: int = 0) -> str:
    """Write the ``imageselect_Dataloader.py`` layout: ``<split>.txt`` of the image paths,
    each label at ``<image>_z.bin``."""
    import cv2

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(num_frames):
        img = _texture(rng, H, W)
        depth = _depth_surface(rng, H, W)
        p = os.path.join(root, f"frame{i:04d}.jpg")
        cv2.imwrite(p, img[..., ::-1].astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 95])
        depth.astype(np.float32).tofile(p + "_z.bin")
        paths.append(p)
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return root


def colmap_pair_scene(rng, H: int = 224, W: int = 224, num_points: int = 64) -> dict:
    """One ``make_pair_scene`` scene as a two-view reconstruction sees it: the images
    (``images``: image 1, image 2), ``depth``, ``K``, ``relative_pose`` [4, 4] (image 1 at
    the world origin, image 2 at the scene's pose), and ``num_points`` anchors at random
    pixels of image 1 (``sparse_xy`` [N, 2], ``sparse_z`` [N] the scene's depth there),
    back-projected (``points`` [N, 3]) and projected into image 2 (``xy2``)."""
    tgt, src, depth, K, pose6 = make_pair_scene(rng, H, W)
    T = pose_matrix(pose6).astype(np.float64)
    xy = rng.uniform(0, [W, H], (num_points, 2))
    z = depth[xy[:, 1].astype(int), xy[:, 0].astype(int)].astype(np.float64)
    pts = np.stack([(xy[:, 0] - K[0, 2]) / K[0, 0] * z, (xy[:, 1] - K[1, 2]) / K[1, 1] * z,
                    z], 1)
    cam2 = pts @ T[:3, :3].T + T[:3, 3]
    xy2 = np.stack([K[0, 0] * cam2[:, 0] / cam2[:, 2] + K[0, 2],
                    K[1, 1] * cam2[:, 1] / cam2[:, 2] + K[1, 2]], 1)
    return {"images": (tgt, src), "depth": depth, "K": K, "pose6": pose6,
            "relative_pose": T.astype(np.float32), "sparse_xy": xy.astype(np.float32),
            "sparse_z": z.astype(np.float32), "points": pts, "xy2": xy2}


def write_colmap_pair(root: str, H: int = 224, W: int = 224, num_points: int = 64,
                      seed: int = 0) -> dict:
    """``colmap_pair_scene`` of ``seed`` as a COLMAP text model in ``root/sparse``
    (``cameras.txt``: one PINHOLE camera of the scene's K; ``images.txt``: ``a.jpg`` at
    the world origin and ``b.jpg`` at the scene's pose, each with its observations;
    ``points3D.txt``: the anchors, each tracked in both) and the two images as JPEGs in
    ``root/images``. Returns the scene with ``model_dir`` and ``image_dir``."""
    import cv2

    scene = colmap_pair_scene(np.random.RandomState(seed), H, W, num_points)
    K, pose6 = scene["K"], scene["pose6"]
    angle = float(np.linalg.norm(pose6[3:]))
    axis = pose6[3:] / angle if angle > 0 else np.zeros(3)
    qvec = [np.cos(angle / 2), *(np.sin(angle / 2) * axis)]   # the rotation vector's
    model, images = os.path.join(root, "sparse"), os.path.join(root, "images")
    os.makedirs(model, exist_ok=True)
    os.makedirs(images, exist_ok=True)
    fmt = lambda vals: " ".join(repr(float(v)) for v in vals)
    with open(os.path.join(model, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {W} {H} {fmt([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])}\n")
    with open(os.path.join(model, "images.txt"), "w") as f:
        for image_id, name, q, t, obs in (
                (1, "a.jpg", [1, 0, 0, 0], [0, 0, 0], scene["sparse_xy"]),
                (2, "b.jpg", qvec, scene["relative_pose"][:3, 3], scene["xy2"])):
            f.write(f"{image_id} {fmt(q)} {fmt(t)} 1 {name}\n")
            f.write(" ".join(f"{fmt(o)} {j + 1}" for j, o in enumerate(obs)) + "\n")
    with open(os.path.join(model, "points3D.txt"), "w") as f:
        for j, p in enumerate(scene["points"]):
            f.write(f"{j + 1} {fmt(p)} 128 128 128 0.5 1 {j} 2 {j}\n")
    for name, img in zip(("a.jpg", "b.jpg"), scene["images"]):
        cv2.imwrite(os.path.join(images, name), img[..., ::-1].astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    return {**scene, "model_dir": model, "image_dir": images}


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
