"""Classic DeMoN v1 HDF5 archives: an in-place reader and a converter to the flat schema.

The port of ``tf_depth_estimation_tpu/data/demon_v1.py``. The reference trains on the
released DeMoN archives (sun3d / rgbd / mvs / scenes11, ``Demon_Data_loader.py:69-79``)
through the C++ ``multi_vi_h5_data_reader``. Two ways to read them:

- ``DemonV1Dataset`` streams the v1 layout in place: a ``DemonDataset`` subclass (the same
  scene-pool draw, augmentation and preprocessing) that the DeMoN CLIs select with
  ``--demon_v1``;
- ``convert_demon_v1`` rewrites archives once into the flat schema ``data/demon.py``
  reads (the decode paid once instead of every draw); ``python -m
  tf_depth_estimation_torch.data.demon_v1 SRC.h5 [SRC2.h5 ...] -o OUT.h5``.

The v1 layout (DeMoN's ``view_io`` training archives; ``write_demon_v1_h5`` writes it)::

    <sample>/frames/t0/v0/image    encoded image bytes (webp / jpeg / png), 1-D uint8
    <sample>/frames/t0/v0/depth    float16 / float32 depth [H, W] (camera z, metric)
    <sample>/frames/t0/v0/camera   float64 [fx fy skew cx cy | R row-major (9) | t (3)]
    <sample>/frames/t0/v1/{image,camera}           the second view; depth optional

``fx fy cx cy`` are normalised by the image width and height, as the flat schema's
4-vector is. Extrinsics are world-to-camera (``x_cam = R x_world + t``); the record's
motion is the camera-1 -> 2 transform as ANGLEAXIS6 ``[rotation vector | translation]``.
Also read: per-view ``K`` (3x3) / ``R`` / ``t`` datasets instead of the packed
17-vector, and raw ``[H, W, 3]`` uint8 images instead of encoded bytes. h5py and PIL are
imported where a file is opened or an image decoded.
"""
from __future__ import annotations

import argparse
import io
from typing import Iterable, Tuple

import numpy as np

from tf_depth_estimation_torch.data.demon import DemonDataset, _matrix_to_rotvec_np
from tf_depth_estimation_torch.data.synthetic import _rotvec_to_matrix_np


def _decode_image(ds) -> np.ndarray:
    """A v1 image dataset, encoded bytes or a raw [H, W, 3] uint8 array, as [H, W, 3]
    uint8."""
    arr = np.asarray(ds)
    if arr.ndim == 3:
        return arr.astype(np.uint8)
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(arr.tobytes())).convert("RGB"), dtype=np.uint8)


def _read_camera(view) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(normalised [fx fy cx cy], R [3, 3], t [3]) of a view, from either layout."""
    if "camera" in view:
        cam = np.asarray(view["camera"], dtype=np.float64).ravel()
        if cam.size != 17:
            raise ValueError(f"camera vector has {cam.size} values, expected 17")
        fx, fy, _skew, cx, cy = cam[:5]
        return np.array([fx, fy, cx, cy]), cam[5:14].reshape(3, 3), cam[14:17]
    K = np.asarray(view["K"], dtype=np.float64)
    R = np.asarray(view["R"], dtype=np.float64).reshape(3, 3)
    t = np.asarray(view["t"], dtype=np.float64).ravel()
    return np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]), R, t


def is_v1_sample(g) -> bool:
    """Whether an HDF5 node holds a complete v1 sample (two views and v0's depth)."""
    try:
        t0 = g["frames/t0"]
        # inside the try: where frames/t0 is a stray dataset, `in` raises
        return "v0" in t0 and "v1" in t0 and "depth" in t0["v0"]
    except (KeyError, TypeError, ValueError, AttributeError):
        return False


def parse_v1_sample(g) -> dict:
    """One v1 sample group -> the flat record (``image_pair``, ``depth``, ``motion``,
    ``intrinsics``), for the converter and the in-place reader alike."""
    t0 = g["frames/t0"]
    v0, v1 = t0["v0"], t0["v1"]
    img0, img1 = _decode_image(v0["image"]), _decode_image(v1["image"])
    depth = np.asarray(v0["depth"], dtype=np.float32)
    if depth.ndim == 1:  # stored flat
        depth = depth.reshape(img0.shape[0], img0.shape[1])
    intr0, R0, t0v = _read_camera(v0)
    _, R1, t1v = _read_camera(v1)
    # the relative motion cam0 -> cam1 under x_cam = R x_world + t
    R_rel = R1 @ R0.T
    t_rel = t1v - R_rel @ t0v
    return {"image_pair": np.concatenate([img0, img1], axis=-1), "depth": depth,
            "motion": np.concatenate([_matrix_to_rotvec_np(R_rel), t_rel]).astype(np.float32),
            "intrinsics": intr0.astype(np.float32)}


def iter_v1_samples(h5file) -> Iterable[Tuple[str, dict]]:
    """(name, flat record) of every complete sample group of a v1 archive, by name."""
    for name in sorted(h5file.keys()):
        g = h5file[name]
        if is_v1_sample(g):
            yield name, parse_v1_sample(g)


def convert_demon_v1(src_paths, out_path: str, verbose: bool = False) -> int:
    """Write the samples of v1 archives into one flat-schema HDF5 file; returns their
    count."""
    import h5py

    n = 0
    with h5py.File(out_path, "w") as out:
        for src in src_paths:
            with h5py.File(src, "r") as f:
                for name, rec in iter_v1_samples(f):
                    g = out.create_group(f"{n:08d}_{name}")
                    g.create_dataset("image_pair", data=rec["image_pair"], compression="gzip")
                    g.create_dataset("depth", data=rec["depth"], compression="gzip")
                    g.create_dataset("motion", data=rec["motion"])
                    g.create_dataset("intrinsics", data=rec["intrinsics"])
                    n += 1
                    if verbose and n % 500 == 0:
                        print(f"converted {n} samples...", flush=True)
    return n


class DemonV1Dataset(DemonDataset):
    """``DemonDataset`` over classic v1 archives, read in place: only the enumeration of
    sample groups and the raw record change; the image bytes are decoded at every draw,
    as the reference's C++ reader does."""

    @staticmethod
    def _enumerate_keys(h5file):
        return [name for name in sorted(h5file.keys()) if is_v1_sample(h5file[name])]

    def _load(self, index: int):
        fi, key = self._keys[index]
        rec = parse_v1_sample(self._files[fi][key])
        return rec["image_pair"], rec["depth"], rec["motion"], rec["intrinsics"]


def write_demon_v1_h5(path: str, num_scenes: int = 4, H: int = 48, W: int = 64,
                      seed: int = 0, encode: str = "webp") -> str:
    """A v1 archive of ``num_scenes`` seeded samples (random images, a small rotation and a
    translation a view, depth in [1, 5] as float16), the images encoded as ``encode``
    (``"webp"`` lossless, ``"png"``, ``"jpeg"``) or ``"raw"`` arrays; the same bytes as
    the JAX package's writer at the same arguments."""
    import h5py
    from PIL import Image

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for i in range(num_scenes):
            g = f.create_group(f"seq{i:03d}-0")
            for v in ("v0", "v1"):
                view = g.create_group(f"frames/t0/{v}")
                img = rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
                if encode == "raw":
                    view.create_dataset("image", data=img)
                else:
                    buf = io.BytesIO()
                    Image.fromarray(img).save(buf, format=encode.upper(),
                                              lossless=(encode == "webp"))
                    view.create_dataset("image", data=np.frombuffer(buf.getvalue(), np.uint8))
                R = _rotvec_to_matrix_np(rng.randn(3) * 0.1)
                t = rng.randn(3)
                fx, fy = 0.9 + 0.2 * rng.rand(2)
                cam = np.concatenate([[fx, fy, 0.0, 0.5, 0.5], R.ravel(), t]).astype(np.float64)
                view.create_dataset("camera", data=cam)
                if v == "v0":
                    view.create_dataset("depth",
                                        data=(1.0 + 4.0 * rng.rand(H, W)).astype(np.float16))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert classic DeMoN v1 HDF5 archives to "
                                             "the flat schema of data/demon.py.")
    ap.add_argument("sources", nargs="+", help="classic DeMoN v1 .h5 archives")
    ap.add_argument("-o", "--output", required=True, help="flat-schema output .h5")
    args = ap.parse_args(argv)
    n = convert_demon_v1(args.sources, args.output, verbose=True)
    print(f"wrote {n} samples to {args.output}")
    return n


if __name__ == "__main__":
    main()
