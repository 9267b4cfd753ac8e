"""NumPy 3D and flow I/O: the port's own copy of ``tf_depth_estimation_tpu/colmap/io.py``
(a py3 rebuild of the reference's ``util.py``), host code with no device work.

Covers: quaternion/axis-angle/matrix converters (``util.py:76-102``),
Middlebury ``.flo`` + PFM readers (``util.py:339-368``), the NumPy bilinear sampler twin
(``util.py:300-335`` — the unit-test oracle for the device sampler), PLY/WRL/XYZ writers
(``util.py:230-296``), and depth->normals->shading (``util.py:40-69``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# -- rotations ------------------------------------------------------------------
def quaternion_to_matrix(q) -> np.ndarray:
    """[qw qx qy qz] -> 3x3 rotation (COLMAP convention, ref ``util.py:76-86``)."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-15:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def axis_angle_to_matrix_np(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / (np.linalg.norm(a) + 1e-15)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def matrix_to_axis_angle_np(R: np.ndarray) -> Tuple[np.ndarray, float]:
    angle = float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    if angle < 1e-12:
        return np.array([1.0, 0.0, 0.0]), 0.0
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2 * np.sin(angle)), angle


# -- flow / pfm readers ----------------------------------------------------------
def read_flow(path: str) -> np.ndarray:
    """Middlebury ``.flo`` (PIEH magic) or PFM optical flow -> [H, W, 2] float32
    (ref ``util.py:339-368``)."""
    if path.endswith(".pfm") or path.endswith(".PFM"):
        data, _scale = read_pfm(path)
        return data[:, :, :2]
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or abs(magic[0] - 202021.25) > 1e-3:  # 'PIEH' as float
            raise ValueError(f"{path}: not a .flo file (bad magic)")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def read_pfm(path: str):
    """PFM image -> (data, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError("not a PFM file")
        dims = f.readline().decode("latin-1").split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    data = data.reshape(h, w, channels)
    return np.flipud(data).copy(), abs(scale)


# -- sampling oracle --------------------------------------------------------------
def bilinear_interpolate(im: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """NumPy bilinear sampler (ref ``util.py:300-335``): clamp-to-border corner taps.

    ``im``: [H, W] or [H, W, C]; x/y: arbitrary-shape float coords.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x0 = np.floor(x).astype(int)
    x1 = x0 + 1
    y0 = np.floor(y).astype(int)
    y1 = y0 + 1

    x0c = np.clip(x0, 0, im.shape[1] - 1)
    x1c = np.clip(x1, 0, im.shape[1] - 1)
    y0c = np.clip(y0, 0, im.shape[0] - 1)
    y1c = np.clip(y1, 0, im.shape[0] - 1)

    Ia = im[y0c, x0c]
    Ib = im[y1c, x0c]
    Ic = im[y0c, x1c]
    Id = im[y1c, x1c]

    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    if im.ndim == 3:
        wa, wb, wc, wd = (w[..., None] for w in (wa, wb, wc, wd))
    return wa * Ia + wb * Ib + wc * Ic + wd * Id


# -- depth geometry ----------------------------------------------------------------
def backproject_grid(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """[H, W] depth + K -> [H, W, 3] camera-frame points (ref ``util.py:60-69``)."""
    H, W = depth.shape
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    x = (xs - K[0, 2]) / K[0, 0] * depth
    y = (ys - K[1, 2]) / K[1, 1] * depth
    return np.stack([x, y, depth], axis=-1)


def normals_from_depth(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Surface normals via intrinsics-scaled finite differences (ref ``util.py:40-55``)."""
    pts = backproject_grid(depth, K)
    dzdx = np.gradient(pts, axis=1)
    dzdy = np.gradient(pts, axis=0)
    n = np.cross(dzdx, dzdy)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    return n


def shading_from_normals(normals: np.ndarray, light=(0.0, 0.0, -1.0)) -> np.ndarray:
    """Lambertian n·l shading image (ref ``util.py:57-58``)."""
    l = np.asarray(light, np.float64)
    l = l / np.linalg.norm(l)
    return np.clip((normals @ l), 0, 1)


# -- 3D writers -------------------------------------------------------------------
def write_xyz(path: str, points: np.ndarray):
    np.savetxt(path, points, fmt="%.6f")


def write_ply_points(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud (ref ``util.py:265-281``)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")


def write_wrl_surface(path: str, depth: np.ndarray, K: np.ndarray, step: int = 1):
    """VRML 2.0 surface mesh from a depth map (ref ``util.py:283-296`` WRL writer)."""
    pts = backproject_grid(depth, K)[::step, ::step]
    H, W = pts.shape[:2]
    with open(path, "w") as f:
        f.write("#VRML V2.0 utf8\nShape {\n geometry IndexedFaceSet {\n  coord Coordinate { point [\n")
        for v in pts.reshape(-1, 3):
            f.write(f"   {v[0]:.6f} {v[1]:.6f} {v[2]:.6f},\n")
        f.write("  ] }\n  coordIndex [\n")
        for i in range(H - 1):
            for j in range(W - 1):
                a = i * W + j
                f.write(f"   {a} {a + W} {a + 1} -1, {a + 1} {a + W} {a + W + 1} -1,\n")
        f.write("  ]\n }\n}\n")


def write_ply_surface(path: str, depth: np.ndarray, K: np.ndarray,
                      step: int = 1):
    """Triangulated grid mesh from a depth map (SfS surface writer,
    ref ``util.py:230-263``): vertices from backprojection, two triangles per grid cell."""
    pts = backproject_grid(depth, K)[::step, ::step]
    H, W = pts.shape[:2]
    verts = pts.reshape(-1, 3)
    faces = []
    for i in range(H - 1):
        for j in range(W - 1):
            a = i * W + j
            b = a + 1
            c = a + W
            d = c + 1
            faces.append((a, c, b))
            faces.append((b, c, d))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"3 {a} {b} {c}\n")
