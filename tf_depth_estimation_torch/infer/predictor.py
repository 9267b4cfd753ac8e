"""Batched depth and pose inference: the port of ``tf_depth_estimation_tpu/infer/
predictor.py``'s ``DepthPredictor``, ``TurboPredictor`` and ``PairPredictor``.

Frames are batched on the host; full batches run at ``batch_size`` and the ragged tail is
padded only up to the next power of two, so the tail wastes less than itself in compute.
uint8 frames cross to the device as uint8 (a quarter of the float32 bytes) and become
``dtype`` there. Padded rows are sliced off on the device before the copy to the host,
and batch i+1 is queued before batch i's result is pulled, so the device does not wait
on the host's copy. ``predict_directory`` keeps the reference's ``<frame>.jpg_z.bin``
output contract (``batch_prediction.py:57-77``) and, for pairs, its ``<frame>.jpg.txt``
pose export (``batch_prediction_cam_est.py:96-98``).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from tf_depth_estimation_torch.infer.fast import fold_weights, folded_forward
from tf_depth_estimation_torch.infer.fast_pose import fold_depth_pose, folded_depth_pose_forward
from tf_depth_estimation_torch.infer.fast_turbo import fold_turbo, folded_turbo_forward
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboVariant
from tf_depth_estimation_torch.weights import turbo_from_variables, variables_to_state_dict


def _load_frame(path: str, height: int, width: int) -> np.ndarray:
    """PIL-open + cv2 INTER_AREA resize, as ``batch_prediction.py:59-62`` (raw 0..255,
    no /255)."""
    import cv2
    import PIL.Image as pil

    img = np.array(pil.open(path).convert("RGB"))
    return cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA).astype(np.float32)


def _postprocess(z: np.ndarray, out_height: int, out_width: int,
                 bilateral: bool = True) -> np.ndarray:
    """Host post-process of ``batch_prediction.py:72-73``: cubic upsize, bilateral filter."""
    import cv2

    z = cv2.resize(z, (out_width, out_height), interpolation=cv2.INTER_CUBIC)
    if bilateral:
        z = cv2.bilateralFilter(z, 9, 75, 75)
    return z.astype(np.float32)


def _batched_apply(fwd: Callable[[torch.Tensor], torch.Tensor], arrays: np.ndarray,
                   batch_size: int, device: torch.device) -> List:
    """Run ``fwd`` over N inputs in batches of ``batch_size``, the ragged tail padded to
    the next power of two; returns the per-batch outputs (a tensor or a tuple of them),
    de-padded, on the host."""
    N = arrays.shape[0]
    outs: List = []
    pending = None  # (device output, rows to keep), queued but not yet pulled

    def pull(out, n):
        if isinstance(out, tuple):
            return tuple(o[:n].cpu().numpy() for o in out)
        return out[:n].cpu().numpy()
    i = 0
    while i < N:
        n = min(batch_size, N - i)
        chunk = arrays[i:i + n]
        bucket = min(1 << (n - 1).bit_length(), batch_size)  # next power of two >= n
        if bucket != n:
            pad = np.zeros((bucket - n, *chunk.shape[1:]), chunk.dtype)
            chunk = np.concatenate([chunk, pad], 0)
        out = fwd(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
        if pending is not None:
            outs.append(pull(*pending))
        pending = (out, n)
        i += n
    if pending is not None:
        outs.append(pull(*pending))
    return outs


def _list_frames(dataset_dir: str) -> List[str]:
    img_list = sorted(glob(os.path.join(dataset_dir, "*.jpg")))
    if not img_list:
        raise FileNotFoundError(
            f"no *.jpg frames in {dataset_dir!r} (frames are globbed "
            "non-recursively, like the reference batch_prediction.py)")
    return img_list


def _resolve_use_fast(use_fast: Optional[bool], batch_stats, height: int,
                      width: int) -> bool:
    """The folded forward needs batch statistics and H, W divisible by 4
    (``fast_pose.py``'s guard): ``use_fast=None`` takes it where it can, ``False`` forces
    the module forward, and ``True`` raises where it cannot."""
    fast_ok = bool(batch_stats) and height % 4 == 0 and width % 4 == 0
    if use_fast is None:
        return fast_ok
    if use_fast and not fast_ok:
        raise ValueError("use_fast=True requires batch_stats and H, W divisible by 4")
    return use_fast


class _SingleImagePredictor:
    """The array and directory contract of the single-image predictors: ``_fwd`` maps a
    [b, H, W, 3] batch on ``device`` to [b, H, W] disparities."""

    height: int
    width: int
    batch_size: int
    device: torch.device
    _fwd: Callable[[torch.Tensor], torch.Tensor]

    def predict_array(self, frames: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] float32 or uint8 -> [N, H, W] float32 disparity."""
        if frames.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"frames must be [N, {self.height}, {self.width}, 3], "
                             f"got {frames.shape}")
        outs = _batched_apply(self._fwd, frames, self.batch_size, self.device)
        return np.concatenate(outs, 0)

    def predict_directory(self, dataset_dir: str, output_dir: str, *,
                          out_height: int = 240, out_width: int = 720,
                          bilateral: bool = True) -> List[str]:
        """Glob ``*.jpg``, write ``<name>_z.bin`` float32 dumps (the reference's output
        contract), a few batches of frames at a time."""
        os.makedirs(output_dir, exist_ok=True)
        img_list = _list_frames(dataset_dir)
        written = []
        chunk = self.batch_size * 4
        for i in range(0, len(img_list), chunk):
            paths = img_list[i:i + chunk]
            frames = np.stack([_load_frame(p, self.height, self.width) for p in paths])
            for path, z in zip(paths, self.predict_array(frames)):
                out = os.path.join(output_dir, os.path.basename(path) + "_z.bin")
                _postprocess(z, out_height, out_width, bilateral).tofile(out)
                written.append(out)
        return written


class DepthPredictor(_SingleImagePredictor):
    """Single-image disparity inference with depth4 DispNet (ref ``batch_prediction.py``).

    ``params`` / ``batch_stats`` are the JAX variables' collections (numpy trees, e.g.
    from ``utils.npz.load_variables_npz``). The forward is ``infer/fast.py`` with BN
    folded once here, and the decoder tail runs as one CUDA kernel (``ops/fused_tail.py``).
    """

    def __init__(self, params, batch_stats, *, height: int = 224, width: int = 224,
                 variant: Optional[DispNetVariant] = None, batch_size: int = 32,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda"):
        self.height, self.width, self.batch_size = height, width, batch_size
        self.device = torch.device(device)
        v = variant or DispNetVariant.depth4()
        folded = fold_weights({"params": params, "batch_stats": batch_stats},
                              dtype=dtype, device=self.device)

        @torch.inference_mode()
        def fwd(x: torch.Tensor) -> torch.Tensor:
            return folded_forward(folded, x, disp_scaling=v.disp_scaling,
                                  min_disp=v.min_disp)[0][..., 0]

        self._fwd = fwd


class TurboPredictor(_SingleImagePredictor):
    """Serving of a TurboDepthNet student (JAX ``infer/predictor.py:TurboPredictor``).

    Raw 0..255 frames, as the reference feeds them (``batch_prediction.py:59-69``, no
    /255) and as ``distill_turbo.py`` distils on them; integer frames cross to the device
    as they are and become ``dtype`` there. ``params`` / ``batch_stats`` are the JAX
    variables' collections (numpy trees). The forward is ``infer/fast_turbo.py`` with BN
    folded once here (``use_fast=True``, the default), or the module's eval ``full_only``
    forward in ``dtype``; both are cuDNN convolutions, with no kernel of this package.
    """

    def __init__(self, params, batch_stats, *, variant: Optional[TurboVariant] = None,
                 height: int = 384, width: int = 576, batch_size: int = 128,
                 dtype: torch.dtype = torch.bfloat16, use_fast: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.height, self.width, self.batch_size = height, width, batch_size
        self.device = torch.device(device)
        v = variant or TurboVariant.base()
        v.check_size(height, width)
        variables = {"params": params, "batch_stats": batch_stats}
        self.uses_fast_path = use_fast
        if use_fast:
            folded = fold_turbo(variables, dtype=dtype, device=self.device)
            forward = lambda x: folded_turbo_forward(folded, x, v)[..., 0]
        else:
            model = turbo_from_variables(variables, v, device=self.device)
            model.dtype = dtype
            forward = lambda x: model(x, full_only=True)[0][..., 0]
        self._fwd = torch.inference_mode()(forward)


class PairPredictor:
    """Consecutive-frame depth and 6-DoF pose export with DepthPoseNet (ref
    ``batch_prediction_cam_est.py``).

    ``params`` / ``batch_stats`` are the JAX variables' collections (numpy trees). With
    batch statistics and H, W divisible by 4 the forward is ``infer/fast_pose.py`` with BN
    folded once here (``use_fast``, as ``_resolve_use_fast`` decides); otherwise the
    module's eval forward in ``dtype``. Pair i is [frame i | frame i + 1]; its output is
    the finest disparity and the pose of frame i + 1 relative to frame i.
    """

    def __init__(self, params, batch_stats=None, *, height: int = 192, width: int = 256,
                 full_resolution: bool = False, batch_size: int = 16,
                 dtype: torch.dtype = torch.bfloat16, use_fast: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.height, self.width, self.batch_size = height, width, batch_size
        self.device = torch.device(device)
        variables = {"params": params, "batch_stats": batch_stats or {}}
        self.uses_fast_path = _resolve_use_fast(use_fast, batch_stats, height, width)
        if self.uses_fast_path:
            folded = fold_depth_pose(variables, dtype=dtype, device=self.device)

            def forward(x):
                disps, pose, _masks = folded_depth_pose_forward(
                    folded, x, full_resolution=full_resolution)
                return disps[0][..., 0], pose[:, 0]
        else:
            model = DepthPoseNet(full_resolution=full_resolution, dtype=dtype)
            model.load_state_dict(variables_to_state_dict(variables), strict=True)
            model = model.to(self.device).eval()

            def forward(x):
                disps, pose, _masks = model(x.permute(0, 3, 1, 2).float())
                return disps[0][:, 0], pose[:, 0]

        self._fwd = torch.inference_mode()(forward)

    def predict_pairs(self, frames: np.ndarray):
        """[N, H, W, 3] float32 or uint8 -> (disparity [N-1, h, w], pose [N-1, 6]) over
        the consecutive pairs."""
        if frames.shape[1:] != (self.height, self.width, 3) or frames.shape[0] < 2:
            raise ValueError(f"frames must be [N >= 2, {self.height}, {self.width}, 3], "
                             f"got {frames.shape}")
        pairs = np.concatenate([frames[:-1], frames[1:]], axis=-1)
        outs = _batched_apply(self._fwd, pairs, self.batch_size, self.device)
        return (np.concatenate([z for z, _ in outs], 0),
                np.concatenate([p for _, p in outs], 0))

    def predict_directory(self, dataset_dir: str, output_dir: str, *,
                          out_height: int = 240, out_width: int = 720,
                          bilateral: bool = True) -> List[str]:
        """Glob ``*.jpg``; for each frame but the last write its pose to ``<frame>.txt``
        beside it and ``<name>_z.bin`` into ``output_dir``, in chunks of a few batches
        that overlap by one frame (pair i needs frames i and i + 1)."""
        os.makedirs(output_dir, exist_ok=True)
        img_list = _list_frames(dataset_dir)
        written = []
        chunk = self.batch_size * 4
        for i in range(0, max(len(img_list) - 1, 0), chunk):
            paths = img_list[i:i + chunk + 1]
            frames = np.stack([_load_frame(p, self.height, self.width) for p in paths])
            depths, poses = self.predict_pairs(frames)
            for path, z, pose in zip(paths[:-1], depths, poses):
                np.savetxt(path + ".txt", pose, fmt="%f")
                out = os.path.join(output_dir, os.path.basename(path) + "_z.bin")
                _postprocess(z, out_height, out_width, bilateral).tofile(out)
                written.append(out)
        return written
