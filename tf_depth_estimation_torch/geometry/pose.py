"""6-DoF pose vectors -> homogeneous 4x4 transforms, and the rigid inverse (port of
``tf_depth_estimation_tpu/geometry/pose.py``, ref ``utils_lr.py:106-149``)."""
from __future__ import annotations

import torch

from tf_depth_estimation_torch.geometry.rotations import euler_to_matrix, rotvec_to_matrix


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] and [..., 3] -> [..., 4, 4] with the bottom row (0, 0, 0, 1)."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def pose_vec_to_mat(vec: torch.Tensor, fmt: str = "euler") -> torch.Tensor:
    """``[..., 6]`` pose [tx ty tz rx ry rz] -> ``[..., 4, 4]``. ``fmt``: ``"euler"``
    (the reference's 'eular', ``euler2mat(rz, ry, rx)``), ``"angleaxis"`` (the last three
    entries a rotation vector) or ``"identity"`` (the reference's 'test': identity
    rotation, zero translation)."""
    t = vec[..., 0:3]
    if fmt in ("euler", "eular"):
        R = euler_to_matrix(vec[..., 5], vec[..., 4], vec[..., 3])
    elif fmt == "angleaxis":
        R = rotvec_to_matrix(vec[..., 3:6])
    elif fmt in ("identity", "test"):
        R = torch.eye(3, dtype=vec.dtype, device=vec.device).expand(*vec.shape[:-1], 3, 3)
        t = torch.zeros_like(t)
    else:
        raise ValueError(f"unknown pose format: {fmt}")
    return _homogeneous(R, t)


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid ``[..., 4, 4]`` transforms: [R^T | -R^T t], with
    -R^T t as float32 products and sums (no TF32)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return _homogeneous(Rt, -(Rt * t[..., None, :]).sum(-1))
