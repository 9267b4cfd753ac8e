"""Differentiable warps: projective inverse warp, flow warp, flow from coordinates and
the left/right depth consistency.

The port of ``tf_depth_estimation_tpu/geometry/warp.py`` (ref ``utils_lr.py:222-274,
369-458, 472-489``), with the pose as a 4x4 matrix (``fmt="matrix"``) or a 6-vector in the
Euler or angle-axis format (``geometry/pose.py``). Images and flows are NHWC, as in the
JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tf_depth_estimation_torch.geometry.camera import (
    cam_to_pixel,
    matmul_f32,
    pad_intrinsics_4x4,
    pixel_grid,
    pixel_to_cam,
)
from tf_depth_estimation_torch.geometry.pose import pose_vec_to_mat
from tf_depth_estimation_torch.geometry.sampling import bilinear_sample


class WarpResult(NamedTuple):
    image: torch.Tensor         # [B, H, W, C] source warped into the target frame
    coords: torch.Tensor        # [B, H, W, 2] source-pixel coordinates
    mask: torch.Tensor          # [B, H, W, 1] bilinear validity weight (wmask)
    warped_depth: torch.Tensor  # [B, H, W, 1] z of the projected points
    pose: torch.Tensor          # [B, 4, 4] the pose matrix


def projective_inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                            intrinsics: torch.Tensor, fmt: str = "euler",
                            sampler: str = "xla") -> WarpResult:
    """Inverse-warp ``img`` [B, H, W, C] (source view) into the target frame given the
    target ``depth`` [B, H, W], ``pose`` ([B, 6] for ``fmt`` "euler" or "angleaxis",
    [B, 4, 4] for "matrix") and ``intrinsics`` [B, 3, 3]."""
    if fmt in ("euler", "eular", "angleaxis"):
        pose = pose_vec_to_mat(pose, fmt)
    elif fmt != "matrix":
        raise ValueError(f"unknown pose format: {fmt}")
    cam_coords = pixel_to_cam(depth, intrinsics)
    proj = matmul_f32(pad_intrinsics_4x4(intrinsics), pose)
    coords, warped_depth = cam_to_pixel(cam_coords, proj)
    out, wmask = bilinear_sample(img, coords, sampler=sampler)
    return WarpResult(out, coords, wmask, warped_depth, pose)


def flow_warp(img: torch.Tensor, flow_x: torch.Tensor, flow_y: torch.Tensor,
              sampler: str = "xla") -> torch.Tensor:
    """Sample ``img`` at the identity grid plus the flow (``flow_x/flow_y``
    [B, H, W, 1])."""
    _, H, W, _ = img.shape
    grid = pixel_grid(H, W, homogeneous=False, device=img.device)
    coords = torch.stack([grid[0][None] + flow_x[..., 0], grid[1][None] + flow_y[..., 0]],
                         -1)
    out, _ = bilinear_sample(img, coords, sampler=sampler)
    return out


def flow_from_coords(src_coords: torch.Tensor):
    """Source-pixel coordinates [B, H, W, 2] -> optical flow with respect to the identity
    grid, (flow_x, flow_y), each [B, H, W, 1]."""
    _, H, W, _ = src_coords.shape
    grid = pixel_grid(H, W, homogeneous=False, device=src_coords.device)
    return (src_coords[..., 0:1] - grid[0][None, ..., None],
            src_coords[..., 1:2] - grid[1][None, ..., None])


def resample_depth(src_depth: torch.Tensor, coords: torch.Tensor,
                   sampler: str = "xla") -> torch.Tensor:
    """Bilinear-sample an (inverse) depth map [B, H, W, 1] of the other view at the warped
    ``coords`` [B, H, W, 2]."""
    return bilinear_sample(src_depth, coords, sampler=sampler)[0]


def consistent_depth_error(src_depth: torch.Tensor, pred_src_depth: torch.Tensor,
                           coords: torch.Tensor, sampler: str = "xla") -> torch.Tensor:
    """|pred_src_depth - sample(src_depth, coords)|, the left/right depth consistency
    (ref ``consistent_depth_loss``, ``utils_lr.py:369-458``)."""
    return (pred_src_depth - resample_depth(src_depth, coords, sampler=sampler)).abs()
