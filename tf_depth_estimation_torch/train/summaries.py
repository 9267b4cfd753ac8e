"""Rich training summaries: per-scale images, depth histograms and the fixed-fixture
inference; the port of ``tf_depth_estimation_tpu/train/summaries.py``.

The reference's summary graph (``split_training.py:275-325``: scalar losses, per-scale
left / right / projected / error images, depth histograms guarded by
``replace_nonfinite``, and the sculpture-pair inference of ``split_training.py:380-393``;
the same pattern in ``train_optflow_combine.py:318-368``). The summaries run the eval
forward at the summary cadence, outside the train step, so a step pays nothing for them.
The pairwise summary's warp takes the JAX summary's default sampler (``"xla"``), the
port's plain version.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tf_depth_estimation_torch.geometry.warp import projective_inverse_warp
from tf_depth_estimation_torch.losses.pipelines import _area

Summaries = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]


def tf1_image_norm(x: np.ndarray) -> np.ndarray:
    """TF1 ``tf.summary.image``'s float rescaling, per image: a non-negative image scales
    so its maximum is 255; otherwise 0 maps to 127 and the extreme value to 0 or 255."""
    x = np.asarray(x, np.float32)
    flat = x.reshape(x.shape[0], -1)
    out = np.empty_like(x, dtype=np.uint8)
    for i in range(x.shape[0]):
        v = x[i]
        mn, mx = float(flat[i].min()), float(flat[i].max())
        if mn >= 0.0:
            scaled = v * (255.0 / mx) if mx > 0 else v
        else:
            scale = 127.0 / max(mx, -mn) if max(mx, -mn) > 0 else 1.0
            scaled = v * scale + 127.0
        out[i] = np.clip(scaled, 0, 255).astype(np.uint8)
    return out


def _finite(x: torch.Tensor) -> torch.Tensor:
    """The histogram guard: the reference wraps labels in ``sops.replace_nonfinite``
    (``split_training.py:283``) because TF histograms refuse NaN and Inf."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _host(tree: dict) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in tree.items()}


def _eval_forward(model, x: torch.Tensor):
    """The model's eval-mode NHWC forward without gradients, its mode restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model.forward_nhwc(x)
    finally:
        model.train(was_training)


def make_pairwise_summary_fn(w, fixture_pair: Optional[np.ndarray] = None,
                             max_images: int = 2) -> Callable:
    """Summaries of the pairwise / split_training family: ``fn(state, batch) -> (images,
    histograms)``, images uint8 [N, H, W, C] and histograms float arrays, of the first
    ``max_images`` pairs of the batch: per scale the left and right images, both views'
    predicted depths, the left image projected from the right and its error, and the
    depth and image histograms (``split_training.py:283-325``). ``fixture_pair``
    ([1, H, W, 6], the reference's sculpture pair) adds the fixed-fixture inference
    ('val_depth', 'val_depth_inv', 'val_image')."""

    def _summarize(model, pair: torch.Tensor, intrinsics: torch.Tensor):
        left, right = pair[..., :3], pair[..., 3:]
        d_l, pose_r, _ = _eval_forward(model, pair)
        d_r, _pose_l, _ = _eval_forward(model, torch.cat([right, left], -1))
        d_l, d_r, pose_r = [d.float() for d in d_l], [d.float() for d in d_r], pose_r.float()
        images, hists = {}, {}
        n = max(w.num_scales - 2, 1)
        # the truncated DepthPoseNet's first prediction sits at pyramid scale 2; the
        # summaries follow the predictions (split_training.py:304-325)
        offset = int(math.log2(pair.shape[1] // d_l[0].shape[1]))
        for s in range(min(n, len(d_l))):
            hw = (d_l[s].shape[1], d_l[s].shape[2])
            sc = min(offset + s, intrinsics.shape[1] - 1)
            cl, cr = _area(left, hw), _area(right, hw)
            depth_l = 1.0 / d_l[s]
            # the pairwise family's poses are angle-axis (losses/pipelines.py)
            warp = projective_inverse_warp(cr, depth_l[..., 0], pose_r[:, 0, :],
                                           intrinsics[:, sc], fmt="angleaxis")
            images[f"scale{s}_left_image"] = cl
            images[f"scale{s}_right_image"] = cr
            images[f"scale{s}_pred_depth_left"] = depth_l
            images[f"scale{s}_pred_depth_right"] = 1.0 / d_r[s]
            images[f"scale{s}_projected_image_left"] = warp.image
            images[f"scale{s}_project_error_left"] = (warp.image - cl).abs()
        hists["scale0_pred_depth_single_left"] = _finite(1.0 / d_l[0])
        hists["scale0_pred_depth_single_right"] = _finite(1.0 / d_r[0])
        hists["image_value_range"] = left
        return images, hists

    def fn(state, batch) -> Summaries:
        pair = batch["image_pair"][:max_images].float()
        images, hists = _summarize(state.model, pair,
                                   batch["intrinsics"][:max_images].float())
        if "depth0" in batch:
            hists["scale_depth"] = _finite(batch["depth0"][:max_images].float())
        images = {k: tf1_image_norm(v) for k, v in _host(images).items()}
        if fixture_pair is not None:
            fixture = torch.from_numpy(np.asarray(fixture_pair, np.float32)).to(pair.device)
            disps, _pose, _ = _eval_forward(state.model, fixture)
            vd = disps[0].float().cpu().numpy()
            images["val_depth"] = tf1_image_norm(1.0 / vd)
            images["val_depth_inv"] = tf1_image_norm(vd)
            images["val_image"] = tf1_image_norm(np.asarray(fixture_pair)[..., 3:] + 0.5)
        return images, _host(hists)

    return fn


def make_depth_summary_fn(w, max_images: int = 2) -> Callable:
    """Summaries of the single-image families (depth_only, optflow_combine; ref
    ``train_optflow_combine.py:318-368``): the target image, each scale's predicted depth,
    and the prediction and label histograms, guarded as ``sops.replace_nonfinite``
    guards them."""

    def fn(state, batch) -> Summaries:
        image = batch.get("tgt_image", batch.get("image"))[:max_images].float()
        outs = [o.float() for o in _eval_forward(state.model, image)]
        images = {"target_image": image}
        hists = {"image_value_range": image}
        for s in range(min(w.num_scales, len(outs))):
            images[f"scale{s}_pred_depth"] = 1.0 / outs[s][..., :1]
        hists["scale0_pred_depth"] = _finite(1.0 / outs[0][..., :1])
        if "label" in batch:
            hists["scale_depth"] = _finite(batch["label"][:max_images].float())
        return {k: tf1_image_norm(v) for k, v in _host(images).items()}, _host(hists)

    return fn
