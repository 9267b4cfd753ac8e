"""Pinhole projection: intrinsics matrices and their pyramid, pixel grids, unprojection by
depth and projection by a 4x4.

The port of ``tf_depth_estimation_tpu/geometry/camera.py`` (ref ``utils_lr.py:151-220``).
Tensors keep the JAX package's layouts: depth [B, H, W], points [B, 4, H, W], pixel
coordinates [B, H, W, 2] in (x, y) order.

The projection is written as explicit float32 multiply-adds, not a matrix product: the
JAX function asks for ``precision="highest"``, and a product that ran in TF32 (cuDNN's and
cuBLAS's fast mode, about three decimal digits) would move a coordinate near x = 480 by
half a pixel. Elementwise float32 arithmetic does not depend on the TF32 flags.
"""
from __future__ import annotations

import torch


def make_intrinsics_matrix(fx, fy, cx, cy) -> torch.Tensor:
    """Batched [..., 3, 3] K from focal lengths and principal point (tensors of one shape;
    ref the loaders' helper)."""
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx], -1), torch.stack([zero, fy, cy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def scale_intrinsics_pyramid(K: torch.Tensor, num_scales: int, x_ratio: float = 1.0,
                             y_ratio: float = 1.0) -> torch.Tensor:
    """[B, 3, 3] -> [B, num_scales, 3, 3]: focal lengths and principal point halved per
    scale, times the resize ratios (``imageselect_Dataloader_optflow.py:248-262``)."""
    ks = []
    for s in range(num_scales):
        f = 1.0 / 2.0**s
        ks.append(make_intrinsics_matrix(
            K[..., 0, 0] * f * x_ratio, K[..., 1, 1] * f * y_ratio,
            K[..., 0, 2] * f * x_ratio, K[..., 1, 2] * f * y_ratio))
    return torch.stack(ks, -3)


def pixel_grid(height: int, width: int, homogeneous: bool = True,
               device=None) -> torch.Tensor:
    """Pixel-coordinate grid ``[2 or 3, H, W]`` float32: (x, y[, 1])."""
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    planes = [x, y, torch.ones_like(x)] if homogeneous else [x, y]
    return torch.stack(planes, 0)


def pixel_to_cam(depth: torch.Tensor, K: torch.Tensor,
                 homogeneous: bool = True) -> torch.Tensor:
    """Unproject ``depth`` [B, H, W] with intrinsics ``K`` [B, 3, 3] to camera points
    ``[B, 3 (4), H, W]``: the closed-form inverse of the triangular K applied to
    (x, y, 1), scaled by depth."""
    B, H, W = depth.shape
    col = lambda v: v[:, None, None]
    fx, fy, cx, cy, sk = (col(K[:, 0, 0]), col(K[:, 1, 1]), col(K[:, 0, 2]),
                          col(K[:, 1, 2]), col(K[:, 0, 1]))
    grid = pixel_grid(H, W, device=depth.device)
    y_cam = (grid[1][None] - cy) / fy
    x_cam = (grid[0][None] - cx - sk * y_cam) / fx
    planes = [x_cam * depth, y_cam * depth, depth]
    if homogeneous:
        planes.append(torch.ones_like(depth))
    return torch.stack(planes, 1)


def cam_to_pixel(cam_coords: torch.Tensor, proj: torch.Tensor, eps: float = 1e-10):
    """Project homogeneous points ``[B, 4, H, W]`` through ``proj`` [B, 4, 4].

    Returns (pixel coordinates ``[B, H, W, 2]``, projected z ``[B, H, W, 1]``), with the
    reference's ``z + 1e-10`` division guard."""
    p = proj.float()[:, :, :, None, None]
    pts = cam_coords.float()

    def row(i):
        return p[:, i, 0] * pts[:, 0] + p[:, i, 1] * pts[:, 1] + p[:, i, 2] * pts[:, 2] \
            + p[:, i, 3] * pts[:, 3]

    x_u, y_u, z_u = row(0), row(1), row(2)
    coords = torch.stack([x_u / (z_u + eps), y_u / (z_u + eps)], -1)
    return coords, z_u[..., None]


def pad_intrinsics_4x4(K: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] K -> [B, 4, 4] (ref: the filler rows of ``utils_lr.py:245-248``)."""
    B = K.shape[0]
    out = torch.zeros((B, 4, 4), dtype=K.dtype, device=K.device)
    out[:, :3, :3] = K
    out[:, 3, 3] = 1.0
    return out


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched [B, n, k] @ [B, k, m] as float32 products and sums, whatever the TF32
    flags say (the 4x4 products of the warp)."""
    return (a.float()[:, :, :, None] * b.float()[:, None, :, :]).sum(2)
