"""COLMAP scene tooling and 3D / flow I/O of the PyTorch port: host NumPy, copied from
``tf_depth_estimation_tpu/colmap`` so that the port imports nothing of the JAX package."""

from tf_depth_estimation_torch.colmap.io import (
    axis_angle_to_matrix_np,
    backproject_grid,
    bilinear_interpolate,
    matrix_to_axis_angle_np,
    normals_from_depth,
    quaternion_to_matrix,
    read_flow,
    read_pfm,
    shading_from_normals,
    write_ply_points,
    write_ply_surface,
    write_wrl_surface,
    write_xyz,
)
from tf_depth_estimation_torch.colmap.scene_manager import Camera, Image, SceneManager

__all__ = [
    "Camera",
    "Image",
    "SceneManager",
    "axis_angle_to_matrix_np",
    "backproject_grid",
    "bilinear_interpolate",
    "matrix_to_axis_angle_np",
    "normals_from_depth",
    "quaternion_to_matrix",
    "read_flow",
    "read_pfm",
    "shading_from_normals",
    "write_ply_points",
    "write_ply_surface",
    "write_wrl_surface",
    "write_xyz",
]
