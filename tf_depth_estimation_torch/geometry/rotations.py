"""Batched rotation parameterisations (port of
``tf_depth_estimation_tpu/geometry/rotations.py``, ref ``utils_lr.py:26-103``): closed
forms written elementwise, so no 3x3 product depends on the TF32 flags."""
from __future__ import annotations

import math

import torch


def _matrix(rows) -> torch.Tensor:
    """[[r00, r01, r02], ...] of [...] tensors -> [..., 3, 3]."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_to_matrix(z: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Euler angles (radians, each clipped to [-pi, pi] as ``utils_lr.py:40-42`` clips
    them) -> ``[..., 3, 3]``, R = Rx @ Ry @ Rz (``utils_lr.py:73``)."""
    z, y, x = (a.clamp(-math.pi, math.pi) for a in (z, y, x))
    cz, sz, cy, sy, cx, sx = z.cos(), z.sin(), y.cos(), y.sin(), x.cos(), x.sin()
    return _matrix([
        [cy * cz, -cy * sz, sy],
        [cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy],
        [sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy]])


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues, I + sin(a) K + (1 - cos(a)) K^2 with K^2 = a a^T - (a.a) I, from
    ``[..., 3]`` axes and ``[...]`` angles (``utils_lr.py:77-103``)."""
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    s, c = angle.sin(), angle.cos()
    t = 1.0 - c
    aa = ax * ax + ay * ay + az * az    # 1 for a unit axis; kept as JAX keeps it
    return _matrix([
        [1.0 + t * (ax * ax - aa), t * ax * ay - s * az, t * ax * az + s * ay],
        [t * ax * ay + s * az, 1.0 + t * (ay * ay - aa), t * ay * az - s * ax],
        [t * ax * az - s * ay, t * ay * az + s * ax, 1.0 + t * (az * az - aa)]])


def rotvec_to_matrix(rotvec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation vector (angle * axis) -> ``[..., 3, 3]``. Where |v|^2 <= eps the angle is
    0 and the axis v itself; the double ``where`` keeps value and gradient finite at
    v = 0, where the reference (``utils_lr.py:128-133``) divides by zero."""
    sq = (rotvec * rotvec).sum(-1)
    big = sq > eps
    one = torch.ones_like(sq)
    angle = torch.where(big, torch.sqrt(torch.where(big, sq, one)), torch.zeros_like(sq))
    axis = rotvec / torch.where(big, angle, one)[..., None]
    return axis_angle_to_matrix(axis, angle)


def matrix_to_axis_angle(R: torch.Tensor, eps: float = 1e-12):
    """Rotation matrix ``[..., 3, 3]`` -> (axis ``[..., 3]``, angle ``[...]``)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    angle = torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    return v / (2.0 * angle.sin()[..., None] + eps), angle
