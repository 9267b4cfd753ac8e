"""The colon loaders (port of ``SimpleDepthDataset``, ``PairDepthDataset`` and
``Dim11Dataset`` in ``tf_depth_estimation_tpu/data/colon.py``, ref
``imageselect_Dataloader.py``, ``imageselect_Dataloader_optflow.py`` and
``imageselect_Dataloader_optflow_dim11.py``).

``SimpleDepthDataset``: a ``<split>.txt`` of image paths, each label beside its image at
``<image>_z.bin`` (raw float32), the image resized to 224x224 and /255, the label
area-resized and inverted to 1/depth.

Each ``<split>.txt`` line ``subfolder id1 id2`` names a side-by-side pair JPEG
``id1_id2.jpg`` (width 2x: target | source), a raw float32 depth
``frame<id1>_<id2>.jpg_z.bin``, a 3x3 intrinsics CSV ``_cam.txt`` and 34 tokens of
``_tgt2src_proj.txt`` (two 4x4 projections, m_scale, a pad value). JPEGs decode with
OpenCV; images are resized with the TF1 bilinear kernel and labels with TF1 area weights,
in NumPy (OpenCV's resizes use half-pixel centres).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from tf_depth_estimation_torch.ops.resize import _area_weights, _bilinear_weights


def _resize_np(img: np.ndarray, out_hw, weights_fn) -> np.ndarray:
    """Separable TF1-parity resize on the host (img: [H, W, C] float32).

    ``optimize=True`` lets einsum hand both contractions to BLAS: the JAX package's
    unoptimised einsum takes ~2.8 s for one 240x1440 pair and this ~13 ms; the sums run
    in another order, so values agree to float32 rounding, not bit for bit."""
    H, W = img.shape[:2]
    out_h, out_w = out_hw
    if (H, W) == (out_h, out_w):
        return img
    Wh = weights_fn(H, out_h)
    Ww = weights_fn(W, out_w)
    return np.einsum("iy,yxc->ixc", Wh, np.einsum("jx,ixc->ijc", Ww, img, optimize=True),
                     optimize=True)


def _resize_bilinear_np(img, out_hw):
    return _resize_np(img, out_hw, _bilinear_weights)


def _resize_area_np(img, out_hw):
    return _resize_np(img, out_hw, _area_weights)


def _decode_jpeg(path: str) -> np.ndarray:
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(path)
    return bgr[..., ::-1].astype(np.float32)  # BGR -> RGB


def _read_bin_depth(path: str, height: int, width: int) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(height, width, 1)


@dataclasses.dataclass
class SimpleDepthDataset:
    """Single image + inverse-depth label (ref ``imageselect_Dataloader.py:8-133``)."""

    dataset_dir: str
    split: str = "train"
    resized_height: int = 224
    resized_width: int = 224

    def __post_init__(self):
        with open(os.path.join(self.dataset_dir, f"{self.split}.txt")) as f:
            self.image_paths = [l.strip() for l in f if l.strip()]
        self.label_paths = [p + "_z.bin" for p in self.image_paths]

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, i: int):
        rh, rw = self.resized_height, self.resized_width
        img = _resize_bilinear_np(_decode_jpeg(self.image_paths[i]), (rh, rw)) / 255.0
        # a label of another size than the training size is taken as square, side^2
        # values (the reference's manifests store it at the training size); area-resize,
        # then invert (imageselect_Dataloader.py:97-101)
        d = np.fromfile(self.label_paths[i], dtype=np.float32)
        if d.size == rh * rw:
            label = d.reshape(rh, rw, 1)
        else:
            side = int(round(d.size ** 0.5))
            label = d.reshape(side, side, 1)
        label = 1.0 / _resize_area_np(label, (rh, rw))
        return {"image": img.astype(np.float32), "label": label.astype(np.float32)}


@dataclasses.dataclass
class PairDepthDataset:
    """Packed image pair + depth + intrinsics + GT projections."""

    dataset_dir: str
    split: str = "train"
    image_height: int = 240      # native label resolution (FLAGS.image_height)
    image_width: int = 720
    resized_height: int = 240
    resized_width: int = 720
    num_scales: int = 4

    def __post_init__(self):
        with open(os.path.join(self.dataset_dir, f"{self.split}.txt")) as f:
            lines = [l.strip().split(" ") for l in f if l.strip()]
        self.entries = []
        for sub, id1, id2 in lines:
            frame = f"{id1}_{id2}"
            base = os.path.join(self.dataset_dir, sub)
            self.entries.append(dict(
                image=os.path.join(base, frame + ".jpg"),
                cam=os.path.join(base, frame + "_cam.txt"),
                depth=os.path.join(base, "frame" + frame + ".jpg" + "_z.bin"),
                proj=os.path.join(base, frame + "_tgt2src_proj.txt")))

    def __len__(self):
        return len(self.entries)

    def intrinsics_pyramid(self, K: np.ndarray) -> np.ndarray:
        """[num_scales, 3, 3]: focal lengths and principal point halved per scale, with
        the resize-ratio correction (``imageselect_Dataloader_optflow.py:59-60,
        248-262``)."""
        xr = self.resized_width / self.image_width
        yr = self.resized_height / self.image_height
        out = np.zeros((self.num_scales, 3, 3), np.float32)
        for s in range(self.num_scales):
            f = 1 / 2**s
            out[s] = [[K[0, 0] * f * xr, 0, K[0, 2] * f * xr],
                      [0, K[1, 1] * f * yr, K[1, 2] * f * yr],
                      [0, 0, 1]]
        return out

    def pixels(self, seq: np.ndarray) -> np.ndarray:
        """The resized pair's pixels as the batch holds them: raw 0..255 here (the
        reference does not divide by 255, imageselect_Dataloader_optflow.py:129)."""
        return seq

    def camera(self, path: str) -> dict:
        """The batch's camera entries from a ``_cam.txt`` (a 3x3 CSV here)."""
        K = np.loadtxt(path, delimiter=",", dtype=np.float32).reshape(3, 3)
        return {"intrinsics": self.intrinsics_pyramid(K)}

    def __getitem__(self, i: int):
        e = self.entries[i]
        rh, rw = self.resized_height, self.resized_width
        seq = self.pixels(_resize_bilinear_np(_decode_jpeg(e["image"]), (rh, rw * 2)))
        # the label is stored at the native size and area-resized to the training size
        # (the reference's set_shape without a resize crashes for differing sizes; the
        # dim11 loader's area-resize is the evident intent)
        label = _read_bin_depth(e["depth"], self.image_height, self.image_width)
        label = _resize_area_np(label, (rh, rw))
        with open(e["proj"]) as f:
            # 34 tokens: two 4x4s, m_scale, a trailing pad value
            tokens = np.array(f.read().split(), dtype=np.float32)[:34]
        return {
            "tgt_image": seq[:, :rw].astype(np.float32),
            "src_image": seq[:, rw:].astype(np.float32),
            "label": label.astype(np.float32),
            **self.camera(e["cam"]),
            "tgt2src_projs": tokens[:32].reshape(2, 4, 4).astype(np.float32),
            "m_scale": np.float32(tokens[32]),
        }


@dataclasses.dataclass
class Dim11Dataset(PairDepthDataset):
    """The dim11 variant (ref ``imageselect_Dataloader_optflow_dim11.py``): 224x224,
    pixels scaled to [-0.5, 0.5], depths read from ``depth_dir`` where given (by the same
    file names), and a ``_cam.txt`` of raw values of which the first 6 (fx fy cx cy and
    2 unused; commas or spaces) become ``cam``; no intrinsics pyramid (the CLI builds
    it)."""

    image_height: int = 224
    image_width: int = 224
    resized_height: int = 224
    resized_width: int = 224
    depth_dir: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        if self.depth_dir:
            for e in self.entries:
                e["depth"] = os.path.join(self.depth_dir, os.path.basename(e["depth"]))

    def pixels(self, seq: np.ndarray) -> np.ndarray:
        return seq / 255.0 - 0.5   # imageselect_Dataloader_optflow_dim11.py:128

    def camera(self, path: str) -> dict:
        with open(path) as f:
            return {"cam": np.array(f.read().replace(",", " ").split(), np.float32)[:6]}
