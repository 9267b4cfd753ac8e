"""Train-step factories of the PyTorch port (``tf_depth_estimation_tpu/train/steps.py``).

A step runs the forward in train mode (which moves the batch-norm running statistics),
the loss, the backward and the Adam update, and returns ``(state, metrics)`` with the state
updated in place and the metrics as detached 0-d float32 tensors (reading them syncs the
device).
A validation step runs the eval-mode forward (running statistics) without gradients and
returns the metrics alone.
"""
from __future__ import annotations

from typing import Dict

import torch

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.losses.pipelines import (
    depth_only_loss,
    depth_only_val_loss,
    depth_then_cam_loss,
    optflow_combine_loss,
    pairwise_depth_loss,
    single_depth_loss,
)
from tf_depth_estimation_torch.train.state import TrainState


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _apply(state: TrainState, total: torch.Tensor, comps: dict):
    """Backward and Adam update; the detached metrics."""
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    state.set_learning_rate()
    state.optimizer.step()
    state.step += 1
    # a gated-off term stays the Python 0.0 it started as
    return state, {k: torch.as_tensor(v, dtype=torch.float32, device=total.device).detach()
                   for k, v in comps.items()}


def make_depth_only_step(w: LossWeights):
    """BASELINE config 2 (``train_depth_only.py``): depth4 DispNet on the target image;
    ``depth_only_loss``. Batch keys: ``tgt_image`` [B, H, W, 3], ``label`` [B, H, W, 1]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        outs = state.model(batch["tgt_image"].permute(0, 3, 1, 2))
        total, comps = depth_only_loss([_nhwc(d) for d in outs], batch["label"], w)
        return _apply(state, total, comps)

    return step


def make_depth_only_val_step(w: LossWeights):
    """Config 2's validation: the eval-mode forward and ``depth_only_val_loss``, without
    gradients; returns the components as detached 0-d tensors."""

    def val_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.eval()
        with torch.no_grad():
            outs = state.model(batch["tgt_image"].permute(0, 3, 1, 2))
            _, comps = depth_only_val_loss([_nhwc(d) for d in outs], batch["label"], w)
        return comps

    return val_step


def make_depth_then_cam_step(w: LossWeights):
    """BASELINE config 3 (``train_depth_then_cam.py``): the full-resolution DepthPoseNet on
    the pair (one train-mode forward); ``depth_then_cam_loss`` with the predicted Euler
    pose. Batch keys: ``image_pair`` [B, H, W, 6] (left | right), ``intrinsics``
    [B, S, 3, 3]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        pair = batch["image_pair"]
        disps, poses, exps = state.model(pair.permute(0, 3, 1, 2))
        total, comps = depth_then_cam_loss(
            pair[..., :3], pair[..., 3:], [_nhwc(d) for d in disps], poses,
            [_nhwc(e) for e in exps], batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step


def make_optflow_combine_step(w: LossWeights):
    """BASELINE config 4 (``train_optflow_combine.py``): depth10_flow DispNet (8 outputs:
    4 depths, 4 flows) on the target image; ``optflow_combine_loss``. Batch keys:
    ``tgt_image``, ``src_image`` [B, H, W, 3], ``label`` [B, H, W, 1], ``intrinsics``
    [B, S, 3, 3], ``tgt2src_projs`` [B, 2, 4, 4]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        outs = state.model(batch["tgt_image"].permute(0, 3, 1, 2))
        n = w.num_scales
        depths = [_nhwc(d) for d in outs[:n]]
        flows = [_nhwc(f) for f in outs[n:]]
        total, comps = optflow_combine_loss(
            batch["tgt_image"], batch["src_image"], depths, [f[..., 0:1] for f in flows],
            [f[..., 1:2] for f in flows], batch["label"], batch["tgt2src_projs"][:, 0],
            batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step


def make_pairwise_step(w: LossWeights, full_scales: bool = False):
    """split_training phase 1 (``split_training.py:209-417``): DepthPoseNet on (L | R) and
    on (R | L), sharing its parameters; ``pairwise_depth_loss``. The running statistics
    move in both forwards, so the second pass's win, as in JAX's step. Batch keys:
    ``image_pair`` [B, H, W, 6], ``rotation`` and ``translation`` [B, 3] (the GT camera
    is [translation | rotation]), ``intrinsics`` [B, S, 3, 3], and the label ``depth2``
    [B, H/4, W/4, 1] (``depth0`` [B, H, W, 1] under ``full_scales``)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        pair = batch["image_pair"]
        left, right = pair[..., :3], pair[..., 3:]
        d_l, pose_r, exp_l = state.model(pair.permute(0, 3, 1, 2))
        d_r, pose_l, exp_r = state.model(torch.cat([right, left], -1).permute(0, 3, 1, 2))
        gt_cam = torch.cat([batch["translation"], batch["rotation"]], -1)
        label = batch["depth0"] if full_scales else batch["depth2"]
        total, comps = pairwise_depth_loss(
            left, right, [_nhwc(d) for d in d_l], pose_r, [_nhwc(e) for e in exp_l],
            [_nhwc(d) for d in d_r], pose_l, [_nhwc(e) for e in exp_r], gt_cam,
            batch["intrinsics"], label, state.step, w, full_scales=full_scales)
        return _apply(state, total, comps)

    return step


def make_single_depth_step(w: LossWeights):
    """split_training phase 2 (``split_training.py:110-147``): depth4 DispNet over
    ``input`` [B, H, W, 4] ([coarse pair depth | image]); ``single_depth_loss`` against
    ``label`` [B, H, W, 1], its sig weight ramped by the state's step."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        outs = state.model(batch["input"].permute(0, 3, 1, 2))
        total, comps = single_depth_loss([_nhwc(d) for d in outs], batch["label"],
                                         state.step, w)
        return _apply(state, total, comps)

    return step
