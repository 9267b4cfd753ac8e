"""Test-time depth refinement against a COLMAP reconstruction: the port of
``tf_depth_estimation_tpu/infer/refine.py`` (ref ``refine_depth.py``).

Gradient descent over a depth4 DispNet's weights on ONE image pair. Each step runs the
train-mode forward on image 1, aligns the predicted depth to the sparse COLMAP points seen
in image 1 by the ratio of medians (``sparse_scale_factor``), and descends on the sum over
four scales of the disparity's second-order smoothness, the photometric error of image 2
warped into image 1 by the scaled depth and the known relative pose, and, where a prior
depth is given, its L1 to the scaled depth (``refine_depth.py:185-215``), with Adam.

On the GPU the step's four smoothness terms are one group call of
``ops/smoothness.py:smoothness_fused_group`` (``csrc/smoothness.cu``: one launch each
way), as ``losses/pipelines.py:_smooth_loss`` routes them, and its four warps one call of
``geometry/sampling.py:bilinear_sample_group`` on the route ``sampler`` names: on
``"pallas"`` ``csrc/bilinear_sample.cu``, one launch each way (coordinate gradients on all
four warps, none for the image), on ``"xla"`` the plain sampler. ``SAMPLER`` is the
port's default and follows the sampler presets' rule of ``PERF.md`` (Findings): a preset
takes the kernels where the median over paired rounds of (kernel step - plain step) is
<= 0 on the card. For this step it is negative on the H100 (``chip_smoke.py`` phase 42,
whose readings ``PERF.md`` keeps), so the port takes ``"pallas"`` where the JAX package
keeps ``"xla"``.

The median is the midpoint of the two middle values at an even count, as ``jnp.median``
takes it (``torch.median`` returns the lower one), through ``torch.quantile``, whose
gradient is JAX's (half to each middle value). The loss and the scale are read back to the
host only at the steps JAX records, ``(i + 1) % 100 == 0`` and the first.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tf_depth_estimation_torch.geometry.sampling import bilinear_sample_group
from tf_depth_estimation_torch.geometry.warp import projective_coords
from tf_depth_estimation_torch.losses.pipelines import _area, _smooth_loss
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.train.state import TrainState, create_train_state
from tf_depth_estimation_torch.train.steps import _apply
from tf_depth_estimation_torch.weights import load_variables, module_variables

SAMPLER = "pallas"


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-d tensor: the mean of the two middle values at an even
    count."""
    return torch.quantile(x, 0.5, interpolation="midpoint")


def sparse_scale_factor(pred_depth: torch.Tensor, sparse_xy: torch.Tensor,
                        sparse_z: torch.Tensor) -> torch.Tensor:
    """median(sparse z) / median(pred depth at the sparse pixels), ``refine_depth.py:
    91-137``. ``pred_depth`` [H, W]; ``sparse_xy`` [N, 2] pixel coordinates, truncated
    toward zero and clipped to the image; ``sparse_z`` [N]."""
    H, W = pred_depth.shape
    xi = sparse_xy[:, 0].to(torch.int32).clamp(0, W - 1).long()
    yi = sparse_xy[:, 1].to(torch.int32).clamp(0, H - 1).long()
    return median(sparse_z) / (median(pred_depth[yi, xi]) + 1e-12)


def refine_inputs(image1: np.ndarray, image2: np.ndarray, relative_pose: np.ndarray,
                  intrinsics: np.ndarray, sparse_xy: np.ndarray, sparse_z: np.ndarray,
                  gt_depth: Optional[np.ndarray] = None,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """The pair's float32 tensors on ``device``: ``x1``, ``x2`` [1, H, W, 3], ``pose``
    [1, 4, 4], ``K`` [1, 3, 3], ``sparse_xy`` [N, 2], ``sparse_z`` [N] and, given a prior,
    ``gt`` [1, H, W, 1]."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    inputs = {"x1": t(image1)[None], "x2": t(image2)[None], "pose": t(relative_pose)[None],
              "K": t(intrinsics)[None], "sparse_xy": t(sparse_xy), "sparse_z": t(sparse_z)}
    if gt_depth is not None:
        inputs["gt"] = t(gt_depth)[None, ..., None]
    return inputs


def refine_state(seed: int = 0, learning_rate: float = 1e-4, init_params=None,
                 device="cuda") -> TrainState:
    """float32 depth4 DispNet from ``seed`` (or with the JAX params tree ``init_params``
    in place of its parameters, its batch statistics the init's, as JAX replaces them)
    and Adam at ``learning_rate``, on ``device``."""
    model = DispNet(DispNetVariant.depth4(), generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        variables = module_variables(model)
        variables["params"] = init_params
        load_variables(model, variables)
    return create_train_state(model.to(device), learning_rate=learning_rate)


def refine_loss(disps, inputs: Dict[str, torch.Tensor], *, smooth_weight: float = 1.0,
                photo_weight: float = 1.0, prior_weight: float = 1.0, num_scales: int = 4,
                sampler: str = SAMPLER) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, scale) of the train-mode disparities ``disps`` ([1, h, w, 1], the finest
    first) on ``inputs`` (``refine_inputs``), as ``loss_fn`` of the JAX module."""
    x1, x2, K = inputs["x1"], inputs["x2"], inputs["K"]
    H, W = x1.shape[1:3]
    scale = sparse_scale_factor(1.0 / disps[0][0, :, :, 0], inputs["sparse_xy"],
                                inputs["sparse_z"])
    hws = [(int(H / 2**s), int(W / 2**s)) for s in range(num_scales)]
    total = _smooth_loss(disps[:num_scales],
                         [smooth_weight / 2**s for s in range(num_scales)])
    # the warps of all scales in one sampler call, K's rows 0-1 scaled by 1 / 2^s
    coords = []
    for s in range(num_scales):
        K_s = torch.cat([K[:, :2] / 2**s, K[:, 2:]], 1)
        coords.append(projective_coords(scale / disps[s][..., 0], inputs["pose"], K_s,
                                        fmt="matrix")[0])
    warped, masks = bilinear_sample_group([_area(x2, hw) for hw in hws], coords, sampler)
    for s, hw in enumerate(hws):
        err = (warped[s] - _area(x1, hw)).abs() * masks[s]
        total = total + photo_weight / 2**s * err.mean()
        if "gt" in inputs:
            prior = (_area(inputs["gt"], hw) - scale / disps[s]).abs().mean()
            total = total + prior_weight / 2**s * prior
    return total, scale


def make_refine_step(**weights):
    """One refinement step, ``step(state, inputs) -> (state, {"total", "scale"})``: the
    train-mode forward on ``x1``, ``refine_loss`` under ``weights`` (its keyword
    arguments), the backward and the Adam update; the metrics are detached 0-d tensors,
    on the device until read."""

    def step(state: TrainState, inputs: Dict[str, torch.Tensor]):
        state.model.train()
        disps = state.model.forward_nhwc(inputs["x1"])
        total, scale = refine_loss(disps, inputs, **weights)
        return _apply(state, total, {"total": total, "scale": scale})

    return step


def refine_result(state: TrainState, inputs: Dict[str, torch.Tensor]) -> np.ndarray:
    """The eval forward's depth [H, W] (float32, host) times its own scale, as at
    ``refine.py:115-119`` of the JAX module."""
    state.model.eval()
    with torch.no_grad():
        disp = state.model(inputs["x1"].permute(0, 3, 1, 2))[0][0, 0]
    depth = 1.0 / disp.cpu().numpy()
    scale = float(sparse_scale_factor(torch.from_numpy(depth), inputs["sparse_xy"].cpu(),
                                      inputs["sparse_z"].cpu()))
    return depth * scale


def refine_depth(image1: np.ndarray, image2: np.ndarray, relative_pose: np.ndarray,
                 intrinsics: np.ndarray, sparse_xy: np.ndarray, sparse_z: np.ndarray, *,
                 gt_depth: Optional[np.ndarray] = None, steps: int = 500,
                 learning_rate: float = 1e-4, smooth_weight: float = 1.0,
                 photo_weight: float = 1.0, prior_weight: float = 1.0, num_scales: int = 4,
                 seed: int = 0, init_params: Optional[Dict[str, Any]] = None,
                 sampler: str = SAMPLER, device="cuda") -> Tuple[np.ndarray, dict]:
    """Optimise DispNet's weights on one pair; returns (refined depth [H, W], history of
    ``loss`` and ``scale`` at the first step and every 100th)."""
    inputs = refine_inputs(image1, image2, relative_pose, intrinsics, sparse_xy, sparse_z,
                           gt_depth, device)
    state = refine_state(seed, learning_rate, init_params, device)
    step = make_refine_step(smooth_weight=smooth_weight, photo_weight=photo_weight,
                            prior_weight=prior_weight, num_scales=num_scales,
                            sampler=sampler)
    history = {"loss": [], "scale": []}
    for i in range(steps):
        state, metrics = step(state, inputs)
        if (i + 1) % 100 == 0 or i == 0:
            history["loss"].append(float(metrics["total"]))
            history["scale"].append(float(metrics["scale"]))
    return refine_result(state, inputs), history
