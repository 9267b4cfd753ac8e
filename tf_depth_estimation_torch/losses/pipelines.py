"""Loss pipelines of the PyTorch port (``tf_depth_estimation_tpu/losses/pipelines.py``).

Each mirrors one reference loss graph, takes the predictions and the batch (NHWC, as in
the JAX package) and returns ``(total, components)``. Ported so far: ``depth_only_loss``
and ``depth_only_val_loss`` (BASELINE config 2), ``depth_then_cam_loss`` (config 3),
``optflow_combine_loss`` (config 4), ``on_demon_loss`` (config 5), ``pairwise_depth_loss``
and ``single_depth_loss`` (the two phases of ``split_training``), ``lr_full_loss`` and
``lr_gt_pose_loss`` (the symmetric L/R family), and the colon-pair families:
``dim11_joint_loss``, ``only_image_loss``, ``optflow_only_loss``, ``optflow3_loss`` and
``multi_source_loss``. The smoothness terms of a loss go through one call of
``ops/smoothness.py:smoothness_fused_group`` (a map of C > 1 channels as its C channel
views) and its sig terms through one of ``ops/sig_l2.py:sig_l2_fused_group``, each map at
its coefficient, and the warps and resamples of a step through one call of
``geometry/sampling.py:bilinear_sample_group``: one CUDA launch each way on the GPU, the
plain versions on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from tf_depth_estimation_torch.geometry.pose import invert_transform, pose_vec_to_mat
from tf_depth_estimation_torch.geometry.sampling import bilinear_sample_group
from tf_depth_estimation_torch.geometry.warp import (
    consistent_depth_error,
    flow_coords,
    flow_from_coords,
    projective_coords,
    projective_inverse_warp,
)
from tf_depth_estimation_torch.losses.basic import (
    explain_reg_loss,
    reference_explain_mask,
    si_log_rmse,
)
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.ops.nonfinite import replace_nonfinite
from tf_depth_estimation_torch.ops.resize import resize_area
from tf_depth_estimation_torch.ops.schedules import ease_out_quad
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_fused_group
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused_group

_SIG_EPS = 1e-6


def _area(x: torch.Tensor, hw) -> torch.Tensor:
    """TF1 ``resize_area`` of an NHWC tensor, returned contiguous NHWC."""
    return resize_area(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1).contiguous()


def _sig_loss(preds: Sequence[torch.Tensor], gts: Sequence[torch.Tensor],
              deltas: Sequence[int], weight: float) -> torch.Tensor:
    """``weight`` times the sum of the sig-image L2 losses between each prediction and its
    GT (ref ``my_losses.py:78-82``), in one call of the kernel's group wrapper; 0 for no
    prediction."""
    if not preds:
        return 0.0
    return sig_l2_fused_group(preds, gts, deltas, [weight] * len(preds), 0.001, _SIG_EPS)[0]


def _smooth_loss(maps: Sequence[torch.Tensor], coefs: Sequence[float]) -> torch.Tensor:
    """sum_k coefs[k] * second-order smoothness of maps[k], in one call of the kernel's
    group wrapper. A map of C > 1 channels (sfm's 3-channel heads) goes as its C channel
    views at ``coefs[k] / C``: each of the term's four means runs over B h w C values, so
    the term is the mean of its channels' terms, and the kernel takes C = 1 maps (strided
    views read in place)."""
    views, view_coefs = [], []
    for m, c in zip(maps, coefs):
        C = m.shape[-1]
        views += [m[..., i:i + 1] for i in range(C)] if C > 1 else [m]
        view_coefs += [c / C] * C
    return smoothness_fused_group(views, view_coefs)[0]


def _smooth_coefs(w: LossWeights, n: int) -> list:
    """The smoothness weight of each of ``n`` scales, ``smooth_weight / 2**s``."""
    return [w.smooth_weight / 2**s for s in range(n)]


def _sig_ramp(step: int, w: LossWeights) -> float:
    """The sig weight, eased in over the first third of ``max_steps``."""
    return ease_out_quad(step, 0.0, w.depth_sig_weight, float(w.max_steps // 3))


def depth_only_loss(pred_depths: Sequence[torch.Tensor], label: torch.Tensor,
                    w: LossWeights):
    """Supervised depth, BASELINE config 2 (ref ``train_depth_only.py:162-219``): per scale
    a plain (unguarded) L1 to the area-resized label and the smoothness of the raw
    prediction."""
    depth_loss = 0.0
    smooth_loss = _smooth_loss(pred_depths[:w.num_scales], _smooth_coefs(w, w.num_scales))
    for s in range(w.num_scales):
        curr_label = _area(label, w.scale_hw(s))
        depth_loss += (curr_label - pred_depths[s]).abs().mean() * w.depth_weight / 2**s
    total = depth_loss + smooth_loss
    return total, {"total": total, "depth": depth_loss, "smooth": smooth_loss}


def depth_only_val_loss(pred_depths: Sequence[torch.Tensor], label: torch.Tensor,
                        w: LossWeights):
    """Config 2's validation branch (ref ``train_depth_only.py:229-253``): per-scale
    si-log-RMSE and smoothness."""
    depth_loss = 0.0
    smooth_loss = _smooth_loss(pred_depths[:w.num_scales], _smooth_coefs(w, w.num_scales))
    for s in range(w.num_scales):
        curr_label = _area(label, w.scale_hw(s))
        depth_loss += si_log_rmse(curr_label, pred_depths[s]) * w.depth_weight / 2**s
    total = depth_loss + smooth_loss
    return total, {"total": total, "si_log_rmse": depth_loss, "smooth": smooth_loss}


def depth_then_cam_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                        pred_disps: Sequence[torch.Tensor], pred_poses: torch.Tensor,
                        pred_exp_logits: Sequence[torch.Tensor], intrinsics: torch.Tensor,
                        w: LossWeights):
    """Self-supervised joint depth and pose (ref ``train_depth_then_cam.py:156-257``,
    BASELINE config 3), per scale: the smoothness of 1/disp divided by 2^s, the
    explainability cross-entropy, and the explainability-weighted photometric L1 of the
    right image warped with the predicted Euler pose at ``intrinsics[:, s]`` (no 1/2^s on
    the photometric term, as in the reference). Over ``min(len(pred_disps),
    w.num_scales)`` scales, as the JAX package iterates (the full-resolution net gives 4).
    ``pred_poses`` [B, 1, 6]; ``intrinsics`` [B, S, 3, 3]; the warps take ``w.sampler``."""
    pixel_loss = exp_loss = 0.0
    B = image_left.shape[0]
    n = min(len(pred_disps), w.num_scales)
    smooth_loss = _smooth_loss([1.0 / pred_disps[s] for s in range(n)], _smooth_coefs(w, n))
    # the warps of all scales in one sampler call, then the terms scale by scale
    rights = [_area(image_right, w.scale_hw(s)) for s in range(n)]
    coords = [projective_coords(1.0 / pred_disps[s][..., 0], pred_poses[:, 0, :],
                                intrinsics[:, s], fmt="euler")[0] for s in range(n)]
    warped, _ = bilinear_sample_group(rights, coords, w.sampler)
    for s in range(n):
        curr_left = _area(image_left, w.scale_hw(s))
        err = (warped[s] - curr_left).abs()
        if w.explain_reg_weight > 0:
            logits = pred_exp_logits[s][..., :2]
            ref_mask = reference_explain_mask(B, w.height, w.width, s, device=logits.device)
            exp_loss += w.explain_reg_weight * explain_reg_loss(logits, ref_mask)
            exp = torch.softmax(logits, -1)[..., 1:2]
            pixel_loss += (err * exp).mean() * w.data_weight
        else:
            pixel_loss += err.mean() * w.data_weight
    total = pixel_loss + smooth_loss + exp_loss
    return total, {"total": total, "pixel": pixel_loss, "smooth": smooth_loss,
                   "exp": exp_loss}


def optflow_combine_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                         pred_depths: Sequence[torch.Tensor],
                         pred_flow_x: Sequence[torch.Tensor],
                         pred_flow_y: Sequence[torch.Tensor], label: torch.Tensor,
                         tgt2src_proj: torch.Tensor, intrinsics: torch.Tensor,
                         w: LossWeights):
    """Joint depth + optical flow (ref ``train_optflow_combine.py:138-240``, BASELINE
    config 4): depth L1, smoothness of depth and both flow components, wmask-weighted
    photometric error of the depth warp and of the flow warp, and flow supervised by the
    GT-depth warp's grid. Three warps per scale: GT depth, predicted depth, flow.
    ``tgt2src_proj`` [B, 4, 4]; ``intrinsics`` [B, S, 3, 3]."""
    depth_loss = pixel_loss = optflow_loss = 0.0
    smooth_loss = _smooth_loss(
        [m for s in range(w.num_scales)
         for m in (pred_depths[s], pred_flow_x[s], pred_flow_y[s])],
        [c for c in _smooth_coefs(w, w.num_scales) for _ in range(3)])
    # three warps a scale (GT depth, predicted depth, flow) in one sampler call
    labels, rights, coords = [], [], []
    for s in range(w.num_scales):
        hw = w.scale_hw(s)
        labels.append(_area(label, hw))
        rights += [_area(image_right, hw)] * 3
        coords += [projective_coords(1.0 / labels[s][..., 0], tgt2src_proj, intrinsics[:, s],
                                     fmt="matrix")[0],
                   projective_coords(1.0 / pred_depths[s][..., 0], tgt2src_proj,
                                     intrinsics[:, s], fmt="matrix")[0],
                   flow_coords(pred_flow_x[s], pred_flow_y[s])]
    warped, masks = bilinear_sample_group(rights, coords, w.sampler)
    for s in range(w.num_scales):
        curr_label = labels[s]
        curr_left = _area(image_left, w.scale_hw(s))

        depth_loss += (curr_label - pred_depths[s]).abs().mean() * w.depth_weight / 2**s

        pred_img, flow_img = warped[3 * s + 1], warped[3 * s + 2]
        wmask = masks[3 * s]  # validity from the GT warp (train_optflow_combine.py:176)
        pixel_loss += ((pred_img - curr_left).abs() * wmask).mean() * w.data_weight / 2**s
        pixel_loss += ((flow_img - curr_left).abs() * wmask).mean() * w.data_weight / 2**s

        gt_fx, gt_fy = flow_from_coords(coords[3 * s])
        optflow_loss += (pred_flow_x[s] - gt_fx).abs().mean() * w.optflow_weight / 2**s
        optflow_loss += (pred_flow_y[s] - gt_fy).abs().mean() * w.optflow_weight / 2**s

    total = depth_loss + smooth_loss + optflow_loss + pixel_loss
    return total, {"total": total, "depth": depth_loss, "smooth": smooth_loss,
                   "optflow": optflow_loss, "pixel": pixel_loss}


def single_depth_loss(pred_depths: Sequence[torch.Tensor], label: torch.Tensor, step: int,
                      w: LossWeights, sig_deltas: Sequence[int] = (2,)):
    """``compute_loss_single_depth`` (``my_losses.py:46-96``), split_training's phase 2:
    per scale a guarded L1 to the area-resized label and the ramped sig loss. The
    reference comments its smoothness term out; it stays 0."""
    depth_loss = smooth_loss = 0.0
    labels = [_area(label, w.scale_hw(s)) for s in range(w.num_scales)]
    sig_loss = _sig_loss(pred_depths[:w.num_scales], labels, sig_deltas, _sig_ramp(step, w))
    for s in range(w.num_scales):
        curr_label = labels[s]
        diff = replace_nonfinite(curr_label - pred_depths[s])
        depth_loss += diff.abs().mean() * w.depth_weight / 2**s
    total = depth_loss + smooth_loss + sig_loss
    return total, {"total": total, "depth": depth_loss, "sig": sig_loss,
                   "smooth": smooth_loss}


def pairwise_depth_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                        pred_depth_left: Sequence[torch.Tensor],
                        pred_poses_right: torch.Tensor,
                        pred_exp_logits_left: Optional[Sequence[torch.Tensor]],
                        pred_depth_right: Sequence[torch.Tensor],
                        pred_poses_left: torch.Tensor,
                        pred_exp_logits_right: Optional[Sequence[torch.Tensor]],
                        gt_right_cam: torch.Tensor, intrinsics: torch.Tensor,
                        label: torch.Tensor, step: int, w: LossWeights, *,
                        full_scales: bool = False):
    """``compute_loss_pairwise_depth``, split_training's phase 1, in the JAX package's two
    modes:

    * default (``my_losses.py:101-313``): scales 2..S-1, a delta-2 sig term per scale,
      predictions indexed ``s - 2`` (the truncated DepthPoseNet);
    * ``full_scales`` (``my_losses_pairtest.py:92-294``): scales 0..S-1, one 5-delta sig
      term at scale 0, predictions indexed ``s``.

    Depth L1, the camera loss of the angle-axis poses in both directions and the ramped
    sig loss always; the photometric, explainability and left/right consistency terms
    gated on their weights as in JAX. ``gt_right_cam`` [B, 6] is [translation |
    rotation]; ``intrinsics`` [B, S, 3, 3]; the warps take ``w.sampler``."""
    depth_loss = pixel_loss = exp_loss = consist_loss = 0.0
    sig_w = _sig_ramp(step, w)
    gt_l2r = pose_vec_to_mat(gt_right_cam, "angleaxis")
    gt_r2l = invert_transform(gt_l2r)
    proj_l2r = pose_vec_to_mat(pred_poses_right[:, 0, :], "angleaxis")
    proj_r2l = pose_vec_to_mat(pred_poses_left[:, 0, :], "angleaxis")
    # rotation Frobenius and translation L2, both directions (my_losses.py:165-168)
    cam_loss = (((gt_l2r[:, :3, :3] - proj_l2r[:, :3, :3]) ** 2).mean() * w.cam_weight_rot
                + ((gt_r2l[:, :3, :3] - proj_r2l[:, :3, :3]) ** 2).mean() * w.cam_weight_rot
                + ((gt_l2r[:, :3, 3] - proj_l2r[:, :3, 3]) ** 2).mean() * w.cam_weight_tran
                + ((gt_r2l[:, :3, 3] - proj_r2l[:, :3, 3]) ** 2).mean() * w.cam_weight_tran)

    if full_scales:
        scales, offset = range(w.num_scales), 0
    else:
        scales, offset = range(2, w.num_scales), 2
    labels = [_area(label, w.scale_hw(s)) for s in scales]
    if full_scales:
        sig_loss = _sig_loss(pred_depth_left[:1], [label], (1, 2, 4, 8, 16), sig_w)
    else:
        sig_loss = _sig_loss([pred_depth_left[s - offset] for s in scales], labels, (2,),
                             sig_w)

    for s, curr_label in zip(scales, labels):
        k = s - offset
        hw = w.scale_hw(s)
        curr_left = _area(image_left, hw)
        curr_right = _area(image_right, hw)
        diff = replace_nonfinite(curr_label - pred_depth_left[k])
        depth_loss += diff.abs().mean() * w.depth_weight / 2**s

        # the reference builds both warps at every scale; the terms below are gated
        warp_left = projective_inverse_warp(curr_right, 1.0 / curr_label[..., 0], gt_l2r,
                                            intrinsics[:, s], fmt="matrix",
                                            sampler=w.sampler)
        warp_right = projective_inverse_warp(curr_left, 1.0 / pred_depth_right[k][..., 0],
                                             gt_r2l, intrinsics[:, s], fmt="matrix",
                                             sampler=w.sampler)
        if w.data_weight > 0 or w.explain_reg_weight > 0 or w.depth_weight_consist > 0:
            exp_l = exp_r = None
            if pred_exp_logits_left is not None:
                logits_l = pred_exp_logits_left[k][..., :2]
                logits_r = pred_exp_logits_right[k][..., :2]
                if w.explain_reg_weight > 0:
                    ref_mask = reference_explain_mask(image_left.shape[0], w.height,
                                                      w.width, s, device=logits_l.device)
                    exp_loss += w.explain_reg_weight * explain_reg_loss(logits_l, ref_mask)
                    exp_loss += w.explain_reg_weight * explain_reg_loss(logits_r, ref_mask)
                exp_l = torch.softmax(logits_l, -1)[..., 1:2]
                exp_r = torch.softmax(logits_r, -1)[..., 1:2]
            if w.data_weight > 0:
                err_left = (warp_left.image - curr_left).abs()
                err_right = (warp_right.image - curr_right).abs()
                pixel_loss += (err_left * (exp_l if exp_l is not None else 1.0)).mean() \
                    * w.data_weight / 2**s
                pixel_loss += (err_right * (exp_r if exp_r is not None else 1.0)).mean() \
                    * w.data_weight / 2**s
            if w.depth_weight_consist > 0 and exp_l is not None:
                # left/right inverse-depth consistency (my_losses.py:286-294)
                r_err = consistent_depth_error(1.0 / pred_depth_right[k],
                                               warp_left.warped_depth, warp_left.coords,
                                               sampler=w.sampler)
                l_err = consistent_depth_error(1.0 / pred_depth_left[k],
                                               warp_right.warped_depth, warp_right.coords,
                                               sampler=w.sampler)
                consist_loss += (r_err * exp_l).mean() * w.depth_weight_consist
                consist_loss += (l_err * exp_r).mean() * w.depth_weight_consist

    total = depth_loss + cam_loss + pixel_loss + consist_loss + sig_loss + exp_loss
    return total, {"total": total, "depth": depth_loss, "cam": cam_loss,
                   "pixel": pixel_loss, "consist": consist_loss, "sig": sig_loss,
                   "exp": exp_loss}


def on_demon_loss(pred_depths: Sequence[torch.Tensor], label: torch.Tensor, w: LossWeights,
                  scale_offset: int = 0, smooth_only: bool = True):
    """DeMoN-stream depth training, BASELINE config 5 (ref
    ``train_depth_only_onDemon.py:138-178``): per prediction the smoothness of 1/pred
    divided by 2^s and an unweighted, unguarded L1 to the area-resized label, at scale
    ``s = i + scale_offset`` (2 for the truncated DepthPoseNet's [disp3, disp4]). The total
    is the smoothness alone, the reference's ``total_loss = smooth_loss``; ``smooth_only=
    False`` adds the L1 term."""
    scales = [i + scale_offset for i in range(len(pred_depths))]
    smooth_loss = _smooth_loss([1.0 / p for p in pred_depths],
                               [w.smooth_weight / 2**s for s in scales])
    depth_loss = 0.0
    for pred, s in zip(pred_depths, scales):
        depth_loss += (_area(label, w.scale_hw(s)) - pred).abs().mean()
    total = smooth_loss if smooth_only else smooth_loss + depth_loss
    return total, {"total": total, "smooth": smooth_loss, "depth": depth_loss}


def _softmax_exp(logits: torch.Tensor) -> torch.Tensor:
    """The explainability weight: softmax over the first two logits, the second's share."""
    return torch.softmax(logits[..., :2], -1)[..., 1:2]


def _lr_warps(image_left, image_right, pair_left, pair_right, poses_l2r, poses_r2l,
              intrinsics, fmt: str, w: LossWeights):
    """The samplings of the L/R losses at every scale in one sampler group call: the right
    image and the right view's inverse depth at the left view's warp coordinates, the left
    image and the left view's inverse depth at the right view's. Per scale a dict of the
    resized images, the warped images, the resampled inverse depths, the projected z of
    each warp and (at s = 0) its pose matrix."""
    imgs, coords, scales = [], [], []
    for s in range(w.num_scales):
        hw = w.scale_hw(s)
        left, right = _area(image_left, hw), _area(image_right, hw)
        c_l, z_l, pose_l = projective_coords(1.0 / pair_left[s][..., 0], poses_l2r,
                                             intrinsics[:, s], fmt=fmt)
        c_r, z_r, pose_r = projective_coords(1.0 / pair_right[s][..., 0], poses_r2l,
                                             intrinsics[:, s], fmt=fmt)
        imgs += [right, left, 1.0 / pair_right[s], 1.0 / pair_left[s]]
        coords += [c_l, c_r, c_l, c_r]
        scales.append({"left": left, "right": right, "z_left": z_l, "z_right": z_r,
                       "pose_left": pose_l, "pose_right": pose_r})
    outs, _ = bilinear_sample_group(imgs, coords, w.sampler)
    for s, sc in enumerate(scales):
        sc["warp_left"], sc["warp_right"], sc["inv_right_at_left"], sc["inv_left_at_right"] \
            = outs[4 * s: 4 * s + 4]
    return scales


def _lr_exp_terms(sc: dict, exp_left, exp_right, s: int, B: int, w: LossWeights):
    """(explainability regulariser, exp-weighted photometric sum, consistency sum) of the
    L/R losses at scale ``s``, before their weights; the first two are 0 where
    ``explain_reg_weight`` is 0, as in JAX."""
    exp_l, exp_r = _softmax_exp(exp_left[s]), _softmax_exp(exp_right[s])
    reg = pixel = 0.0
    if w.explain_reg_weight > 0:
        ref_mask = reference_explain_mask(B, w.height, w.width, s, device=exp_l.device)
        reg = (explain_reg_loss(exp_left[s][..., :2], ref_mask)
               + explain_reg_loss(exp_right[s][..., :2], ref_mask))
        pixel = (((sc["warp_left"] - sc["left"]).abs() * exp_l).mean()
                 + ((sc["warp_right"] - sc["right"]).abs() * exp_r).mean())
    # the left/right inverse-depth consistency (consistent_depth_error)
    consist = (((sc["z_left"] - sc["inv_right_at_left"]).abs() * exp_l).mean()
               + ((sc["z_right"] - sc["inv_left_at_right"]).abs() * exp_r).mean())
    return reg, pixel, consist


def lr_full_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                 single_left: Sequence[torch.Tensor], single_right: Sequence[torch.Tensor],
                 pair_left: Sequence[torch.Tensor], pair_right: Sequence[torch.Tensor],
                 pred_poses_right: torch.Tensor, pred_poses_left: torch.Tensor,
                 exp_left: Sequence[torch.Tensor], exp_right: Sequence[torch.Tensor],
                 gt_right_cam: torch.Tensor, intrinsics: torch.Tensor, label: torch.Tensor,
                 w: LossWeights):
    """Full symmetric L/R training (ref ``train_depth_then_cam_lr.py:211-355``), per
    scale: the smoothness of 1/d of all four depth lists divided by 2^s; the guarded L1 of
    the single-view left prediction times ``depth_weight`` (no 1/2^s); the
    explainability-weighted photometric L1 of both views warped with the predicted
    angle-axis poses times ``data_weight`` (no 1/2^s); at s = 0 the full-4x4 pose MSE to
    the GT in both directions times ``cam_weight``; the exp-weighted L/R inverse-depth
    consistency times ``depth_weight``. ``gt_right_cam`` [B, 6] is [translation |
    rotation]; ``pred_poses_*`` [B, 1, 6]; ``intrinsics`` [B, S, 3, 3]."""
    B, n = image_left.shape[0], w.num_scales
    smooth_loss = _smooth_loss(
        [1.0 / d[s] for s in range(n) for d in (pair_left, pair_right, single_left,
                                                single_right)],
        [c for c in _smooth_coefs(w, n) for _ in range(4)])
    depth_loss = pixel_loss = exp_loss = cam_loss = consist_loss = 0.0
    gt_l2r = pose_vec_to_mat(gt_right_cam, "angleaxis")
    scales = _lr_warps(image_left, image_right, pair_left, pair_right,
                       pred_poses_right[:, 0, :], pred_poses_left[:, 0, :], intrinsics,
                       "angleaxis", w)
    for s, sc in enumerate(scales):
        diff = replace_nonfinite(_area(label, w.scale_hw(s)) - single_left[s])
        depth_loss += diff.abs().mean() * w.depth_weight
        if s == 0:
            cam_loss += ((gt_l2r - sc["pose_left"]) ** 2).mean() * w.cam_weight
            cam_loss += ((invert_transform(gt_l2r) - sc["pose_right"]) ** 2).mean() \
                * w.cam_weight
        reg, pixel, consist = _lr_exp_terms(sc, exp_left, exp_right, s, B, w)
        exp_loss += w.explain_reg_weight * reg
        pixel_loss += pixel * w.data_weight
        consist_loss += consist * w.depth_weight
    total = pixel_loss + smooth_loss + exp_loss + cam_loss + consist_loss + depth_loss
    return total, {"total": total, "pixel": pixel_loss, "smooth": smooth_loss,
                   "exp": exp_loss, "cam": cam_loss, "consist": consist_loss,
                   "depth": depth_loss}


def lr_gt_pose_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                    pair_left: Sequence[torch.Tensor], pair_right: Sequence[torch.Tensor],
                    pred_poses_right: torch.Tensor, pred_poses_left: torch.Tensor,
                    exp_left: Sequence[torch.Tensor], exp_right: Sequence[torch.Tensor],
                    gt_right_cam: torch.Tensor, intrinsics: torch.Tensor,
                    label: torch.Tensor, w: LossWeights):
    """GT-supervised symmetric L/R training (ref
    ``train_depth_then_cam_lr_gtdepth_gtcam.py:195-340``): no single-view net; the warps
    take the predicted pose matrices (``fmt="matrix"``); the cam loss is the reference's
    asymmetric quirk, the rotation of l2r against the GT times ``cam_weight_rot`` and the
    translation of r2l against the inverse GT times ``cam_weight_tran``; an un-ramped
    5-delta sig term on ``pair_left[0]`` against the full-resolution label times
    ``sig_depth_weight``; the depth L1, photometric and consistency terms carry 1/2^s
    (consistency at ``consist_weight``)."""
    B, n = image_left.shape[0], w.num_scales
    gt_l2r = pose_vec_to_mat(gt_right_cam, "angleaxis")
    pose_l2r = pose_vec_to_mat(pred_poses_right[:, 0, :], "angleaxis")
    pose_r2l = pose_vec_to_mat(pred_poses_left[:, 0, :], "angleaxis")
    cam_loss = (((gt_l2r[:, :3, :3] - pose_l2r[:, :3, :3]) ** 2).mean() * w.cam_weight_rot
                + ((invert_transform(gt_l2r)[:, :3, 3] - pose_r2l[:, :3, 3]) ** 2).mean()
                * w.cam_weight_tran)
    sig_loss = _sig_loss(pair_left[:1], [label], (1, 2, 4, 8, 16), w.sig_depth_weight)
    smooth_loss = _smooth_loss(
        [1.0 / d[s] for s in range(n) for d in (pair_left, pair_right)],
        [c for c in _smooth_coefs(w, n) for _ in range(2)])
    depth_loss = pixel_loss = exp_loss = consist_loss = 0.0
    scales = _lr_warps(image_left, image_right, pair_left, pair_right, pose_l2r, pose_r2l,
                       intrinsics, "matrix", w)
    for s, sc in enumerate(scales):
        diff = replace_nonfinite(_area(label, w.scale_hw(s)) - pair_left[s])
        depth_loss += diff.abs().mean() * w.depth_weight / 2**s
        reg, pixel, consist = _lr_exp_terms(sc, exp_left, exp_right, s, B, w)
        exp_loss += w.explain_reg_weight * reg
        pixel_loss += pixel * w.data_weight / 2**s
        consist_loss += consist * w.consist_weight / 2**s
    total = (pixel_loss + smooth_loss + exp_loss + cam_loss + consist_loss + depth_loss
             + sig_loss)
    return total, {"total": total, "pixel": pixel_loss, "smooth": smooth_loss,
                   "exp": exp_loss, "cam": cam_loss, "consist": consist_loss,
                   "depth": depth_loss, "sig": sig_loss}


def dim11_joint_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                     pred_depths: Sequence[torch.Tensor], pred_poses: torch.Tensor,
                     pred_exp_logits: Sequence[torch.Tensor], intrinsics: torch.Tensor,
                     label: torch.Tensor, w: LossWeights):
    """Joint depth and pose with depth supervision (ref
    ``train_depth_only_dim11.py:207-297``), per scale: the smoothness of the raw prediction
    divided by 2^s, the plain depth L1 times ``depth_weight`` (no 1/2^s), and the
    photometric L1 of the right image warped with the predicted Euler pose times
    ``data_weight`` (no 1/2^s), explainability-weighted with its cross-entropy where
    ``explain_reg_weight`` > 0. Over ``min(len(pred_depths), w.num_scales)`` scales, the
    warps in one sampler call. ``pred_poses`` [B, 1, 6]; ``intrinsics`` [B, S, 3, 3]."""
    depth_loss = pixel_loss = exp_loss = 0.0
    B = image_left.shape[0]
    n = min(len(pred_depths), w.num_scales)
    smooth_loss = _smooth_loss(pred_depths[:n], _smooth_coefs(w, n))
    rights = [_area(image_right, w.scale_hw(s)) for s in range(n)]
    coords = [projective_coords(1.0 / pred_depths[s][..., 0], pred_poses[:, 0, :],
                                intrinsics[:, s], fmt="euler")[0] for s in range(n)]
    warped, _ = bilinear_sample_group(rights, coords, w.sampler)
    for s in range(n):
        hw = w.scale_hw(s)
        depth_loss += (_area(label, hw) - pred_depths[s]).abs().mean() * w.depth_weight
        err = (warped[s] - _area(image_left, hw)).abs()
        if w.explain_reg_weight > 0:
            ref_mask = reference_explain_mask(B, w.height, w.width, s,
                                              device=err.device)
            exp_loss += w.explain_reg_weight * explain_reg_loss(
                pred_exp_logits[s][..., :2], ref_mask)
            pixel_loss += (err * _softmax_exp(pred_exp_logits[s])).mean() * w.data_weight
        else:
            pixel_loss += err.mean() * w.data_weight
    total = depth_loss + smooth_loss + pixel_loss + exp_loss
    return total, {"total": total, "depth": depth_loss, "smooth": smooth_loss,
                   "pixel": pixel_loss, "exp": exp_loss}


def _gt_proj_warps(image_right: torch.Tensor, pred_depths: Sequence[torch.Tensor],
                   tgt2src_proj: torch.Tensor, intrinsics: torch.Tensor, w: LossWeights):
    """The right image of each scale warped by 1/pred[..., 0] with the GT transform
    ``tgt2src_proj`` [B, 4, 4] (``fmt="matrix"``), in one sampler call."""
    n = w.num_scales
    rights = [_area(image_right, w.scale_hw(s)) for s in range(n)]
    coords = [projective_coords(1.0 / pred_depths[s][..., 0], tgt2src_proj,
                                intrinsics[:, s], fmt="matrix")[0] for s in range(n)]
    return bilinear_sample_group(rights, coords, w.sampler)[0]


def only_image_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                    pred_depths: Sequence[torch.Tensor], tgt2src_proj: torch.Tensor,
                    intrinsics: torch.Tensor, w: LossWeights):
    """Photometric-only training with the GT relative transform (ref
    ``train_onlyimage.py:130-165``): per scale the L1 of the right image warped by 1/pred
    with the GT 4x4 times ``data_weight / 2^s``, and the smoothness of the raw
    prediction."""
    n = w.num_scales
    smooth_loss = _smooth_loss(pred_depths[:n], _smooth_coefs(w, n))
    warped = _gt_proj_warps(image_right, pred_depths, tgt2src_proj, intrinsics, w)
    pixel_loss = 0.0
    for s in range(n):
        curr_left = _area(image_left, w.scale_hw(s))
        pixel_loss += (warped[s] - curr_left).abs().mean() * w.data_weight / 2**s
    total = pixel_loss + smooth_loss
    return total, {"total": total, "pixel": pixel_loss, "smooth": smooth_loss}


def optflow_only_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                      pred_flow_x: Sequence[torch.Tensor],
                      pred_flow_y: Sequence[torch.Tensor], label: torch.Tensor,
                      tgt2src_proj: torch.Tensor, intrinsics: torch.Tensor,
                      w: LossWeights):
    """Flow-only training (ref ``train_optflow_only.py:120-167``), per scale: the
    photometric L1 of the flow warp times ``data_weight / 2^s``, the smoothness of both
    flow components, and the L1 to the flow of the GT-depth warp's grid times
    ``optflow_weight / 2^s``. The GT warp's grid feeds only ``flow_from_coords``, so its
    coordinates are built and nothing is sampled (JAX's sampled image there is dead code);
    the 4 flow warps go through one sampler call."""
    n = w.num_scales
    smooth_loss = _smooth_loss(
        [f[s] for s in range(n) for f in (pred_flow_x, pred_flow_y)],
        [c for c in _smooth_coefs(w, n) for _ in range(2)])
    rights = [_area(image_right, w.scale_hw(s)) for s in range(n)]
    flows, _ = bilinear_sample_group(
        rights, [flow_coords(pred_flow_x[s], pred_flow_y[s]) for s in range(n)], w.sampler)
    pixel_loss = optflow_loss = 0.0
    for s in range(n):
        hw = w.scale_hw(s)
        curr_label = _area(label, hw)
        pixel_loss += (flows[s] - _area(image_left, hw)).abs().mean() * w.data_weight / 2**s
        gt_coords = projective_coords(1.0 / curr_label[..., 0], tgt2src_proj,
                                      intrinsics[:, s], fmt="matrix")[0]
        gt_fx, gt_fy = flow_from_coords(gt_coords)
        optflow_loss += (pred_flow_x[s] - gt_fx).abs().mean() * w.optflow_weight / 2**s
        optflow_loss += (pred_flow_y[s] - gt_fy).abs().mean() * w.optflow_weight / 2**s
    total = pixel_loss + smooth_loss + optflow_loss
    return total, {"total": total, "pixel": pixel_loss, "smooth": smooth_loss,
                   "optflow": optflow_loss}


def optflow3_loss(image_left: torch.Tensor, image_right: torch.Tensor,
                  pred_depths: Sequence[torch.Tensor], label: torch.Tensor,
                  tgt2src_proj: torch.Tensor, intrinsics: torch.Tensor, w: LossWeights):
    """3-channel-head depth training (ref ``train_optflow.py:95-135``), per scale: the L1
    of the whole 3-channel prediction against the broadcast label times ``depth_weight /
    2^s``, the smoothness of the prediction (its 3 channel views), and where
    ``data_weight`` > 0 (0 in the preset) the photometric L1 of the right image warped by
    1/pred[..., 0] with the GT 4x4 times ``data_weight / 2^s``."""
    n = w.num_scales
    smooth_loss = _smooth_loss(pred_depths[:n], _smooth_coefs(w, n))
    warped = (_gt_proj_warps(image_right, pred_depths, tgt2src_proj, intrinsics, w)
              if w.data_weight > 0 else None)
    depth_loss = pixel_loss = 0.0
    for s in range(n):
        hw = w.scale_hw(s)
        depth_loss += (_area(label, hw) - pred_depths[s]).abs().mean() \
            * w.depth_weight / 2**s
        if warped is not None:
            pixel_loss += (warped[s] - _area(image_left, hw)).abs().mean() \
                * w.data_weight / 2**s
    total = depth_loss + smooth_loss + pixel_loss
    return total, {"total": total, "depth": depth_loss, "smooth": smooth_loss,
                   "pixel": pixel_loss}


def multi_source_loss(tgt_image: torch.Tensor, src_images: Sequence[torch.Tensor],
                      pred_disps: Sequence[torch.Tensor], label: torch.Tensor,
                      tgt2src_projs: torch.Tensor, intrinsics: torch.Tensor,
                      w: LossWeights):
    """SfMLearner-style multi-source training (ref ``train.py:95-165``), per scale: the
    smoothness of the prediction (3 channel views) and the unweighted L1 of the 3-channel
    prediction against the broadcast label; the photometric L1 of each source warped by
    1/pred[..., 0] with its GT transform times ``data_weight / 2^s`` is computed for the
    record only: the reference's total is smooth + depth (``train.py:160``). So the warps
    of every scale and source run under ``torch.no_grad()`` in one sampler call, forward
    only. ``src_images``: [B, H, W, 3] each; ``tgt2src_projs`` [B, S, 4, 4]."""
    n = w.num_scales
    smooth_loss = _smooth_loss(pred_disps[:n], _smooth_coefs(w, n))
    depth_loss = 0.0
    for s in range(n):
        depth_loss += (_area(label, w.scale_hw(s)) - pred_disps[s]).abs().mean()
    with torch.no_grad():
        srcs, coords = [], []
        for s in range(n):
            for i, src in enumerate(src_images):
                srcs.append(_area(src, w.scale_hw(s)))
                coords.append(projective_coords(1.0 / pred_disps[s][..., 0],
                                                tgt2src_projs[:, i], intrinsics[:, s],
                                                fmt="matrix")[0])
        warped, _ = bilinear_sample_group(srcs, coords, w.sampler)
        pixel_loss = 0.0
        for s in range(n):
            curr_tgt = _area(tgt_image, w.scale_hw(s))
            for i in range(len(src_images)):
                pixel_loss += (warped[s * len(src_images) + i] - curr_tgt).abs().mean() \
                    * w.data_weight / 2**s
    total = smooth_loss + depth_loss
    return total, {"total": total, "smooth": smooth_loss, "depth": depth_loss,
                   "pixel": pixel_loss}
