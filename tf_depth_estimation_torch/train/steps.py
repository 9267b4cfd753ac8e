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
    dim11_joint_loss,
    lr_full_loss,
    lr_gt_pose_loss,
    multi_source_loss,
    on_demon_loss,
    only_image_loss,
    optflow3_loss,
    optflow_combine_loss,
    optflow_only_loss,
    pairwise_depth_loss,
    single_depth_loss,
)
from tf_depth_estimation_torch.train.state import TrainState


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
    """BASELINE config 2 (``train_depth_only.py``): depth4 DispNet, or a TurboDepthNet
    (``depth_only --turbo``), on the target image; ``depth_only_loss``. Batch keys:
    ``tgt_image`` [B, H, W, 3], ``label`` [B, H, W, 1]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        outs = state.model.forward_nhwc(batch["tgt_image"])
        total, comps = depth_only_loss(outs, batch["label"], w)
        return _apply(state, total, comps)

    return step


def make_depth_only_val_step(w: LossWeights):
    """Config 2's validation: the eval-mode forward and ``depth_only_val_loss``, without
    gradients; returns the components as detached 0-d tensors."""

    def val_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.eval()
        with torch.no_grad():
            outs = state.model.forward_nhwc(batch["tgt_image"])
            _, comps = depth_only_val_loss(outs, batch["label"], w)
        return comps

    # si_log_rmse is the square root of means: the mean of its values on two shards is
    # not its value on the whole batch (parallel/dp.py:make_dp_step refuses it)
    val_step.not_data_parallel = "si_log_rmse is not a mean over the batch's samples"
    return val_step


def make_depth_then_cam_step(w: LossWeights):
    """BASELINE config 3 (``train_depth_then_cam.py``): the full-resolution DepthPoseNet on
    the pair (one train-mode forward); ``depth_then_cam_loss`` with the predicted Euler
    pose. Batch keys: ``image_pair`` [B, H, W, 6] (left | right), ``intrinsics``
    [B, S, 3, 3]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        pair = batch["image_pair"]
        disps, poses, exps = state.model.forward_nhwc(pair)
        total, comps = depth_then_cam_loss(pair[..., :3], pair[..., 3:], disps, poses, exps,
                                           batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step


def make_optflow_combine_step(w: LossWeights):
    """BASELINE config 4 (``train_optflow_combine.py``): depth10_flow DispNet (8 outputs:
    4 depths, 4 flows) on the target image; ``optflow_combine_loss``. Batch keys:
    ``tgt_image``, ``src_image`` [B, H, W, 3], ``label`` [B, H, W, 1], ``intrinsics``
    [B, S, 3, 3], ``tgt2src_projs`` [B, 2, 4, 4]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        outs = state.model.forward_nhwc(batch["tgt_image"])
        n = w.num_scales
        depths, flows = outs[:n], outs[n:]
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
        d_l, pose_r, exp_l = state.model.forward_nhwc(pair)
        d_r, pose_l, exp_r = state.model.forward_nhwc(torch.cat([right, left], -1))
        gt_cam = torch.cat([batch["translation"], batch["rotation"]], -1)
        label = batch["depth0"] if full_scales else batch["depth2"]
        total, comps = pairwise_depth_loss(
            left, right, d_l, pose_r, exp_l, d_r, pose_l, exp_r, gt_cam,
            batch["intrinsics"], label, state.step, w, full_scales=full_scales)
        return _apply(state, total, comps)

    return step


def make_single_depth_step(w: LossWeights):
    """split_training phase 2 (``split_training.py:110-147``): depth4 DispNet over
    ``input`` [B, H, W, 4] ([coarse pair depth | image]); ``single_depth_loss`` against
    ``label`` [B, H, W, 1], its sig weight ramped by the state's step."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        outs = state.model.forward_nhwc(batch["input"])
        total, comps = single_depth_loss(outs, batch["label"], state.step, w)
        return _apply(state, total, comps)

    return step


def make_on_demon_step(w: LossWeights, smooth_only: bool = True):
    """BASELINE config 5 (``train_depth_only_onDemon.py``): the truncated DepthPoseNet on
    the DeMoN pair; ``on_demon_loss`` on [disp3, disp4] at scales 2 and 3 against the
    label ``depth0`` [B, H, W, 1], the smoothness alone unless ``smooth_only=False``.
    Batch keys: ``image_pair`` [B, H, W, 6], ``depth0``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        disps, _, _ = state.model.forward_nhwc(batch["image_pair"])
        total, comps = on_demon_loss(disps, batch["depth0"], w, scale_offset=2,
                                     smooth_only=smooth_only)
        return _apply(state, total, comps)

    return step


def _lr_inputs(state: TrainState, batch: Dict[str, torch.Tensor]):
    """(left, right, LRNet's outputs, the GT camera [translation | rotation])."""
    pair = batch["image_pair"]
    left, right = pair[..., :3], pair[..., 3:]
    out = state.model(left, right)
    return left, right, out, torch.cat([batch["translation"], batch["rotation"]], -1)


def make_lr_full_step(w: LossWeights):
    """``train_depth_then_cam_lr.py``: ``LRNet`` (the single-view net on each view, the
    pair net in both orders; each moves its running statistics twice) under
    ``lr_full_loss``. Batch keys: ``image_pair`` [B, H, W, 6], ``rotation`` and
    ``translation`` [B, 3], ``intrinsics`` [B, S, 3, 3], ``depth0`` [B, H, W, 1]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        left, right, out, gt_cam = _lr_inputs(state, batch)
        total, comps = lr_full_loss(
            left, right, out["single_left"], out["single_right"], out["pair_left"],
            out["pair_right"], out["pose_right"], out["pose_left"], out["exp_left"],
            out["exp_right"], gt_cam, batch["intrinsics"], batch["depth0"], w)
        return _apply(state, total, comps)

    return step


def make_lr_gt_step(w: LossWeights):
    """``train_depth_then_cam_lr_gtdepth_gtcam.py``: ``LRNet(with_single=False)``, the pair
    net in both orders, under ``lr_gt_pose_loss``; the batch keys of
    ``make_lr_full_step``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        left, right, out, gt_cam = _lr_inputs(state, batch)
        total, comps = lr_gt_pose_loss(
            left, right, out["pair_left"], out["pair_right"], out["pose_right"],
            out["pose_left"], out["exp_left"], out["exp_right"], gt_cam,
            batch["intrinsics"], batch["depth0"], w)
        return _apply(state, total, comps)

    return step


def _pair(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stacked pair [target | source], [B, H, W, 6]."""
    return torch.cat([batch["tgt_image"], batch["src_image"]], -1)


def make_dim11_step(w: LossWeights):
    """``train_depth_only_dim11.py``: the full-resolution DepthPoseNet on the stacked
    colon pair; ``dim11_joint_loss`` with the predicted Euler pose. Batch keys:
    ``tgt_image``, ``src_image`` [B, H, W, 3] (in [-0.5, 0.5]), ``label`` [B, H, W, 1],
    ``intrinsics`` [B, S, 3, 3]."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        disps, poses, exps = state.model.forward_nhwc(_pair(batch))
        total, comps = dim11_joint_loss(batch["tgt_image"], batch["src_image"], disps,
                                        poses, exps, batch["intrinsics"], batch["label"], w)
        return _apply(state, total, comps)

    return step


def make_only_image_step(w: LossWeights):
    """``train_onlyimage.py``: DispNet on the stacked pair; ``only_image_loss`` with the
    GT transform. Batch keys: those of ``make_optflow_combine_step``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        preds = state.model.forward_nhwc(_pair(batch))
        total, comps = only_image_loss(batch["tgt_image"], batch["src_image"], preds,
                                       batch["tgt2src_projs"][:, 0], batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step


def make_optflow_only_step(w: LossWeights):
    """``train_optflow_only.py``: sfm DispNet on the target image; channels 0 and 1 of its
    3-channel heads are flow x and y (channel views, not copies); ``optflow_only_loss``.
    Batch keys: those of ``make_optflow_combine_step``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        preds = state.model.forward_nhwc(batch["tgt_image"])
        total, comps = optflow_only_loss(
            batch["tgt_image"], batch["src_image"], [p[..., 0:1] for p in preds],
            [p[..., 1:2] for p in preds], batch["label"], batch["tgt2src_projs"][:, 0],
            batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step


def make_sfm_multi_step(w: LossWeights):
    """``train.py``: sfm DispNet on the target image; ``multi_source_loss`` with the one
    source view and its GT transforms. Batch keys: those of
    ``make_optflow_combine_step``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        preds = state.model.forward_nhwc(batch["tgt_image"])
        total, comps = multi_source_loss(batch["tgt_image"], [batch["src_image"]], preds,
                                         batch["label"], batch["tgt2src_projs"],
                                         batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step


def make_optflow3_step(w: LossWeights):
    """``train_optflow.py``: sfm DispNet on the stacked pair; ``optflow3_loss`` (the
    broadcast L1). Batch keys: those of ``make_optflow_combine_step``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.train()
        preds = state.model.forward_nhwc(_pair(batch))
        total, comps = optflow3_loss(batch["tgt_image"], batch["src_image"], preds,
                                     batch["label"], batch["tgt2src_projs"][:, 0],
                                     batch["intrinsics"], w)
        return _apply(state, total, comps)

    return step
