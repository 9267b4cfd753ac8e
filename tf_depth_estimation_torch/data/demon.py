"""DeMoN-style HDF5 dataset with the reference reader's sampling and preprocessing.

The port of ``tf_depth_estimation_tpu/data/demon.py`` (the reference's C++
``multi_vi_h5_data_reader``, ``Demon_Data_loader.py:43-142``), numpy on the host:

- weighted sampling across HDF5 sources (``Demon_Data_loader.py:69-74``) through a scene
  pool (default 650) that ``sample(rng)`` draws from and refills under a lock;
- augmentation: rot180 and mirror-x, each with p = 0.5, conjugating the relative motion
  and reflecting the principal point;
- ``ANGLEAXIS6`` motion [rotation vector | translation], translation normalised to unit
  length and depth scaled by the same factor, inverse depth;
- the labels ``depth0`` (full resolution) and ``depth2`` (1/4, TF1 area resize) and the
  per-scale pixel intrinsics.

On-disk schema (``data/synthetic.py:write_demon_h5`` writes it): one HDF5 group per
sample with ``image_pair`` uint8 [H, W, 6], ``depth`` float32 [H, W], ``motion`` float32
[6] and ``intrinsics`` float32 [4] (normalised fx fy cx cy). ``h5py`` is imported where a
file is opened; ``augment`` and ``preprocess`` need none. The classic DeMoN v1 archives
(``--demon_v1``) are read by ``data/demon_v1.py:DemonV1Dataset``, a subclass that
overrides ``_enumerate_keys`` and ``_load``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Sequence, Tuple

import numpy as np

from tf_depth_estimation_torch.data.colon import _resize_area_np, _resize_bilinear_np
from tf_depth_estimation_torch.data.synthetic import _rotvec_to_matrix_np


def _matrix_to_rotvec_np(R: np.ndarray) -> np.ndarray:
    angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if angle < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2 * np.sin(angle)) * angle


@dataclasses.dataclass
class DemonReaderParams:
    """The reference's reader_params (``Demon_Data_loader.py:52-66``)."""

    batch_size: int = 16
    scaled_height: int = 192
    scaled_width: int = 256
    inverse_depth: bool = True
    norm_trans_scale_depth: bool = True
    scene_pool_size: int = 650
    augment_rot180: float = 0.5
    augment_mirror_x: float = 0.5
    test_phase: bool = False
    num_scales: int = 4


def augment(params: DemonReaderParams, pair, depth, motion, intr, rng):
    """rot180 and mirror-x, each with its probability, drawn from ``rng`` in that order;
    the motion and the principal point follow the images."""
    R = _rotvec_to_matrix_np(motion[:3].astype(np.float64))
    t = motion[3:].astype(np.float64)
    fx, fy, cx, cy = intr  # normalised
    if rng.rand() < params.augment_rot180:
        # both image planes turned by 180 degrees: conjugate with D = diag(-1, -1, 1)
        pair, depth = pair[::-1, ::-1].copy(), depth[::-1, ::-1].copy()
        D = np.diag([-1.0, -1.0, 1.0])
        R, t = D @ R @ D, D @ t
        cx, cy = 1.0 - cx, 1.0 - cy
    if rng.rand() < params.augment_mirror_x:
        # mirrored about x: conjugate with M = diag(-1, 1, 1); R stays proper
        pair, depth = pair[:, ::-1].copy(), depth[:, ::-1].copy()
        M = np.diag([-1.0, 1.0, 1.0])
        R, t = M @ R @ M, M @ t
        cx = 1.0 - cx
    motion = np.concatenate([_matrix_to_rotvec_np(R), t]).astype(np.float32)
    return pair, depth, motion, np.array([fx, fy, cx, cy], np.float32)


def preprocess(params: DemonReaderParams, pair, depth, motion, intr) -> dict:
    """A raw record -> the training sample: ``image_pair`` [H, W, 6] in [-0.5, 0.5],
    ``depth0`` [H, W, 1] and ``depth2`` [H/4, W/4, 1] (inverse depth under
    ``inverse_depth``), ``rotation`` and ``translation`` [3], ``intrinsics`` [S, 3, 3] in
    pixels, all float32."""
    Hs, Ws = params.scaled_height, params.scaled_width
    img = pair.astype(np.float32)
    if img.shape[:2] != (Hs, Ws):
        img = _resize_bilinear_np(img, (Hs, Ws))
        depth = _resize_area_np(depth[..., None], (Hs, Ws))[..., 0]
    img = img / 255.0 - 0.5
    if params.norm_trans_scale_depth:
        s = float(np.linalg.norm(motion[3:]))
        if s > 1e-12:
            motion = motion.copy()
            motion[3:] /= s
            depth = depth / s
    depth0 = depth[..., None]
    if params.inverse_depth:
        with np.errstate(divide="ignore"):
            depth0 = 1.0 / depth0
    depth2 = _resize_area_np(depth0, (Hs // 4, Ws // 4))
    fx, fy, cx, cy = intr
    K = np.array([[fx * Ws, 0, cx * Ws], [0, fy * Hs, cy * Hs], [0, 0, 1]], np.float32)
    pyr = np.zeros((params.num_scales, 3, 3), np.float32)
    for s_ in range(params.num_scales):
        f = 1 / 2**s_
        pyr[s_] = [[K[0, 0] * f, 0, K[0, 2] * f], [0, K[1, 1] * f, K[1, 2] * f], [0, 0, 1]]
    return {"image_pair": img.astype(np.float32), "depth0": depth0.astype(np.float32),
            "depth2": depth2.astype(np.float32), "rotation": motion[:3].astype(np.float32),
            "translation": motion[3:].astype(np.float32), "intrinsics": pyr}


class DemonDataset:
    """Indexable view over weighted HDF5 sources ``[(path, weight), ...]``:
    ``__getitem__`` for deterministic access (augmented by a generator keyed on the index
    unless ``test_phase``) and ``sample(rng)`` for the scene-pool stream of
    ``StreamLoader``."""

    def __init__(self, sources: Sequence[Tuple[str, float]],
                 params: DemonReaderParams | None = None, seed: int = 0):
        import h5py

        self.params = params or DemonReaderParams()
        self._files = []
        self._keys: List[Tuple[int, str]] = []
        weights = []
        for path, weight in sources:
            f = h5py.File(path, "r")
            fi = len(self._files)
            self._files.append(f)
            keys = self._enumerate_keys(f)
            if not keys:
                continue
            self._keys.extend((fi, k) for k in keys)
            weights.extend([weight / len(keys)] * len(keys))
        if not self._keys:
            raise ValueError("no samples found in sources")
        w = np.asarray(weights, np.float64)
        self._probs = w / w.sum()
        # scene pool: pre-drawn weighted sample indices, refilled as they are used
        self._pool = list(np.random.RandomState(seed).choice(
            len(self._keys), size=min(self.params.scene_pool_size, max(1, len(self._keys))),
            p=self._probs))
        self._pool_lock = threading.Lock()  # StreamLoader's workers draw concurrently

    @staticmethod
    def _enumerate_keys(h5file) -> List[str]:
        """The sample groups of one archive (a hook for layout subclasses)."""
        return sorted(h5file.keys())

    def __len__(self):
        return len(self._keys)

    def close(self):
        for f in self._files:
            f.close()

    def _load(self, index: int):
        fi, key = self._keys[index]
        g = self._files[fi][key]
        return (np.asarray(g["image_pair"], np.uint8), np.asarray(g["depth"], np.float32),
                np.asarray(g["motion"], np.float32), np.asarray(g["intrinsics"], np.float32))

    def __getitem__(self, index: int) -> dict:
        record = self._load(index % len(self._keys))
        if not self.params.test_phase:
            # a generator keyed by the index keeps the loader's workers deterministic
            record = augment(self.params, *record, np.random.RandomState(
                (index * 2654435761) & 0x7FFFFFFF))
        return preprocess(self.params, *record)

    def sample(self, rng: np.random.RandomState) -> dict:
        """A scene-pool draw: a random slot's sample, the slot refilled from the weighted
        sources (``Demon_Data_loader.py:65``); then augmentation and preprocessing."""
        with self._pool_lock:
            slot = rng.randint(len(self._pool))
            index = self._pool[slot]
            self._pool[slot] = int(rng.choice(len(self._keys), p=self._probs))
        record = self._load(index)
        if not self.params.test_phase:
            record = augment(self.params, *record, rng)
        return preprocess(self.params, *record)
