"""Batched depth and pose inference: the port of ``tf_depth_estimation_tpu/infer/
predictor.py``'s ``DepthPredictor``, ``TurboPredictor``, ``FlowAugmentedPredictor`` and
``PairPredictor``.

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

import contextlib
import os
from glob import glob
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from tf_depth_estimation_torch.colmap.io import bilinear_interpolate
from tf_depth_estimation_torch.infer.fast import fold_weights, folded_forward
from tf_depth_estimation_torch.infer.fast_pose import fold_depth_pose, folded_depth_pose_forward
from tf_depth_estimation_torch.infer.fast_turbo import fold_turbo, folded_turbo_forward
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboVariant
from tf_depth_estimation_torch.parallel.dp import replica_devices
from tf_depth_estimation_torch.weights import (
    load_variables,
    turbo_from_variables,
)


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
                   batch_size: int, device: torch.device, min_chunk: int = 1) -> List:
    """Run ``fwd`` over N inputs in batches of ``batch_size``, the ragged tail padded to
    the next power of two, at least ``min_chunk`` and rounded up to a multiple of it (a
    sharded predictor passes its device count, so every shard of the tail is equal; JAX
    ``infer/predictor.py:37-99``); returns the per-batch outputs (a tensor or a tuple of
    them), de-padded, on the host."""
    if batch_size % min_chunk:
        # the tail bucket is clamped to batch_size, which keeps it divisible only so
        raise ValueError(f"batch_size ({batch_size}) must be a multiple of min_chunk "
                         f"({min_chunk})")
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
        bucket = max(min_chunk, 1 << (n - 1).bit_length())  # next power of two >= n
        bucket = min(-(-bucket // min_chunk) * min_chunk, batch_size)
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


def _replicated(make_forward: Callable[[torch.device], Callable], devices: List[torch.device]
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """One forward over ``len(devices)`` replicas (``make_forward(device)`` builds each,
    its weights on that device): the batch, on ``devices[0]``, is split into equal shards,
    shard i runs on device i, and the outputs are joined on ``devices[0]``. On the CPU the
    replicas run in turn. JAX's ``_jit_sharded`` shards the batch over a mesh the same
    way (``infer/predictor.py:126-137`` there)."""
    if len(devices) == 1:
        return make_forward(devices[0])
    forwards = [make_forward(d) for d in devices]

    def forward(x: torch.Tensor) -> torch.Tensor:
        outs = []
        for fwd, d, part in zip(forwards, devices, x.chunk(len(devices))):
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                outs.append(fwd(part.to(d, non_blocking=True)))
        return torch.cat([o.to(devices[0]) for o in outs])

    return forward


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
    _min_chunk: int = 1

    def _set_devices(self, device, num_devices: int) -> List[torch.device]:
        """``num_devices`` replica devices from ``device`` (``parallel.replica_devices``:
        raises where the machine has fewer), the batch size divisible by their count."""
        devices = replica_devices(device, num_devices)
        if self.batch_size % num_devices:
            raise ValueError(f"batch_size {self.batch_size} must divide evenly across "
                             f"{num_devices} devices")
        self.device, self.num_devices, self._min_chunk = devices[0], num_devices, num_devices
        return devices

    def predict_array(self, frames: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] float32 or uint8 -> [N, H, W] float32 disparity."""
        if frames.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"frames must be [N, {self.height}, {self.width}, 3], "
                             f"got {frames.shape}")
        outs = _batched_apply(self._fwd, frames, self.batch_size, self.device,
                              self._min_chunk)
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
    """Single-image disparity inference with DispNet (ref ``batch_prediction.py``).

    ``params`` / ``batch_stats`` are the JAX variables' collections (numpy trees, e.g.
    from ``utils.npz.load_variables_npz``). For a variant with batch norm, one decoder and
    sigmoid heads (depth4), with batch statistics and H, W divisible by 4, the forward is
    ``infer/fast.py`` with BN folded once here, its decoder tail one CUDA kernel
    (``ops/fused_tail.py``); ``use_fast=None`` (the default) takes it there, ``False``
    forces the module's eval forward in ``dtype``, and ``True`` raises where it cannot
    serve, as in the JAX package (``infer/predictor.py:211-219`` there). depth10_flow (a
    flow decoder), sfm (3-channel linear heads; channel 0 is served) and depth4_nobn (no
    batch norm) are served by the module forward. ``uses_fast_path`` says which forward
    runs. ``num_devices`` replicates the weights on ``cuda:0 .. N-1`` (from ``device``'s
    index) and splits each batch over them (``_replicated``); ``batch_size`` must divide
    by N, and N above the machine's device count raises.
    """

    def __init__(self, params, batch_stats=None, *, height: int = 224, width: int = 224,
                 variant: Optional[DispNetVariant] = None, batch_size: int = 32,
                 dtype: torch.dtype = torch.bfloat16, use_fast: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda", num_devices: int = 1):
        self.height, self.width, self.batch_size = height, width, batch_size
        devices = self._set_devices(device, num_devices)
        v = variant or DispNetVariant.depth4()
        variables = {"params": params, "batch_stats": batch_stats or {}}
        # the folded forward has batch norm to fold, one decoder and sigmoid heads
        foldable = v.use_bn and not v.flow_decoder and v.head_activation == "sigmoid"
        if use_fast and not foldable:
            raise ValueError("use_fast=True requires a BN single-decoder sigmoid-head "
                             f"variant, not {v.name}")
        self.uses_fast_path = foldable and _resolve_use_fast(use_fast, batch_stats, height,
                                                             width)
        if not self.uses_fast_path and v.use_bn and not batch_stats:
            raise ValueError(f"DispNet {v.name} has batch norm: its eval forward needs "
                             f"batch_stats")

        def make_forward(dev):
            if self.uses_fast_path:
                folded = fold_weights(variables, dtype=dtype, device=dev)
                return lambda x: folded_forward(folded, x, disp_scaling=v.disp_scaling,
                                                min_disp=v.min_disp)[0][..., 0]
            model = DispNet(v, dtype=dtype)
            load_variables(model, variables)
            model = model.to(dev).eval()
            return lambda x: model(x.permute(0, 3, 1, 2).float())[0][:, 0]

        self._fwd = torch.inference_mode()(_replicated(make_forward, devices))


class TurboPredictor(_SingleImagePredictor):
    """Serving of a TurboDepthNet student (JAX ``infer/predictor.py:TurboPredictor``).

    Raw 0..255 frames, as the reference feeds them (``batch_prediction.py:59-69``, no
    /255) and as ``distill_turbo.py`` distils on them; integer frames cross to the device
    as they are and become ``dtype`` there. ``params`` / ``batch_stats`` are the JAX
    variables' collections (numpy trees). The forward is ``infer/fast_turbo.py`` with BN
    folded once here (``use_fast=True``, the default), or the module's eval ``full_only``
    forward in ``dtype``; both are cuDNN convolutions, with no kernel of this package.
    ``num_devices`` replicates and splits as in ``DepthPredictor``.
    """

    def __init__(self, params, batch_stats, *, variant: Optional[TurboVariant] = None,
                 height: int = 384, width: int = 576, batch_size: int = 128,
                 dtype: torch.dtype = torch.bfloat16, use_fast: bool = True,
                 device: Union[str, torch.device] = "cuda", num_devices: int = 1):
        self.height, self.width, self.batch_size = height, width, batch_size
        devices = self._set_devices(device, num_devices)
        v = variant or TurboVariant.base()
        v.check_size(height, width)
        variables = {"params": params, "batch_stats": batch_stats}
        self.uses_fast_path = use_fast

        def make_forward(dev):
            if use_fast:
                folded = fold_turbo(variables, dtype=dtype, device=dev)
                return lambda x: folded_turbo_forward(folded, x, v)[..., 0]
            model = turbo_from_variables(variables, v, device=dev)
            model.dtype = dtype
            return lambda x: model(x, full_only=True)[0][..., 0]

        self._fwd = torch.inference_mode()(_replicated(make_forward, devices))


def _depth_pose_forward(variables: dict, *, full_resolution: bool, in_channels: int,
                        dtype: torch.dtype, use_fast: bool, device: torch.device):
    """``forward(x [b, H, W, C]) -> (disps, pose, masks)`` of a DepthPoseNet, NHWC: the
    folded forward (``infer/fast_pose.py``) or the module's eval forward in ``dtype``."""
    if use_fast:
        folded = fold_depth_pose(variables, dtype=dtype, device=device)
        return lambda x: folded_depth_pose_forward(folded, x,
                                                   full_resolution=full_resolution)
    model = DepthPoseNet(full_resolution=full_resolution, dtype=dtype,
                         in_channels=in_channels)
    load_variables(model, variables)
    model = model.to(device).eval()
    return lambda x: model.forward_nhwc(x.float())


class FlowAugmentedPredictor:
    """Depth from the 11-channel flow-augmented input [I | I1 | flow (2) | warp(I1, flow)]
    with DepthPoseNet (ref ``batch_prediction_optflow.py:106-139``; JAX
    ``infer/predictor.py:FlowAugmentedPredictor``).

    ``assemble_input`` builds one frame's input on the host with the NumPy bilinear
    sampler (``colmap/io.py:bilinear_interpolate``), as the reference and the JAX package
    do; ``predict`` batches the inputs through the folded forward (``infer/fast_pose.py``,
    where ``_resolve_use_fast`` allows) or the module's eval forward in ``dtype``, and
    returns the finest disparity. ``params`` / ``batch_stats`` are the JAX variables'
    collections (numpy trees) of a net whose cnv1 takes 11 channels.
    """

    def __init__(self, params, batch_stats=None, *, height: int = 192, width: int = 256,
                 full_resolution: bool = False, batch_size: int = 16,
                 dtype: torch.dtype = torch.bfloat16, use_fast: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.height, self.width, self.batch_size = height, width, batch_size
        self.device = torch.device(device)
        variables = {"params": params, "batch_stats": batch_stats or {}}
        self.uses_fast_path = _resolve_use_fast(use_fast, batch_stats, height, width)
        forward = _depth_pose_forward(variables, full_resolution=full_resolution,
                                      in_channels=11, dtype=dtype,
                                      use_fast=self.uses_fast_path, device=self.device)
        self._fwd = torch.inference_mode()(lambda x: forward(x)[0][0][..., 0])

    @staticmethod
    def assemble_input(I: np.ndarray, I1: np.ndarray, flow: np.ndarray) -> np.ndarray:
        """The [H, W, 11] float32 input of one frame pair and its flow [H, W, 2]."""
        H, W = I1.shape[:2]
        xs, ys = np.meshgrid(np.linspace(0, W - 1, W), np.linspace(0, H - 1, H))
        I_warp = bilinear_interpolate(
            I1, (xs + flow[:, :, 0]).reshape(-1), (ys + flow[:, :, 1]).reshape(-1)
        ).reshape(H, W, 3).astype(np.float32)
        return np.concatenate(
            [I.astype(np.float32), I1.astype(np.float32), flow.astype(np.float32), I_warp],
            axis=2)

    def predict(self, inputs: np.ndarray) -> np.ndarray:
        """[N, H, W, 11] -> [N, h, w] float32 disparity (pow2-bucketed ragged tail)."""
        if inputs.shape[1:] != (self.height, self.width, 11):
            raise ValueError(f"inputs must be [N, {self.height}, {self.width}, 11], "
                             f"got {inputs.shape}")
        return np.concatenate(_batched_apply(self._fwd, inputs, self.batch_size,
                                             self.device), 0)


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
        forward = _depth_pose_forward(variables, full_resolution=full_resolution,
                                      in_channels=6, dtype=dtype,
                                      use_fast=self.uses_fast_path, device=self.device)

        def pair_forward(x):
            disps, pose, _masks = forward(x)
            return disps[0][..., 0], pose[:, 0]

        self._fwd = torch.inference_mode()(pair_forward)

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
