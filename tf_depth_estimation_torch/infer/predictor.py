"""Batched depth inference: the port of ``tf_depth_estimation_tpu/infer/predictor.py``.

Frames are batched on the host; full batches run at ``batch_size`` and the ragged tail is
padded only up to the next power of two, so the tail wastes less than itself in compute.
uint8 frames cross to the device as uint8 (a quarter of the float32 bytes) and become
``dtype`` there. Padded rows are sliced off on the device before the copy to the host,
and batch i+1 is queued before batch i's result is pulled, so the device does not wait
on the host's copy. ``predict_directory`` keeps the reference's ``<frame>.jpg_z.bin``
output contract (``batch_prediction.py:57-77``).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from tf_depth_estimation_torch.infer.fast import fold_weights, folded_forward
from tf_depth_estimation_torch.models.dispnet import DispNetVariant


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
                   batch_size: int, device: torch.device) -> List[np.ndarray]:
    """Run ``fwd`` over N frames in batches of ``batch_size``, the ragged tail padded to
    the next power of two; returns the per-batch outputs, de-padded, on the host."""
    N = arrays.shape[0]
    outs: List[np.ndarray] = []
    pending = None  # (device output, rows to keep), queued but not yet pulled
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
            outs.append(pending[0][:pending[1]].cpu().numpy())
        pending = (out, n)
        i += n
    if pending is not None:
        outs.append(pending[0][:pending[1]].cpu().numpy())
    return outs


class DepthPredictor:
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
        img_list = sorted(glob(os.path.join(dataset_dir, "*.jpg")))
        if not img_list:
            raise FileNotFoundError(
                f"no *.jpg frames in {dataset_dir!r} (frames are globbed "
                "non-recursively, like the reference batch_prediction.py)")
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
