"""COLMAP text-model parsing and sparse-point queries: the port's own copy of
``tf_depth_estimation_tpu/colmap/scene_manager.py``, host NumPy.

A Python-3 rebuild of the reference's ``scene_manager.py`` (itself derived from COLMAP's
scripts): ``Camera`` intrinsics models with iterative undistortion
(``scene_manager.py:7-85``), text-model loading (``scene_manager.py:153-236``), per-image
3D point lookup (``:258-271``), frustum-filtered visibility (``:277-300``) and quality
filtering by track length / reprojection error / triangulation angle (``:305-335``).
Vectorized NumPy throughout (no per-point Python loops on the hot queries).
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from tf_depth_estimation_torch.colmap.io import quaternion_to_matrix


class Camera:
    """Pinhole/radial camera models with undistortion.

    Supported models (as in the reference): SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL,
    RADIAL, OPENCV.
    """

    def __init__(self, model: str, width: int, height: int, params):
        self.model = model
        self.width = int(width)
        self.height = int(height)
        p = np.asarray(params, np.float64)
        if model == "SIMPLE_PINHOLE":
            self.fx = self.fy = p[0]
            self.cx, self.cy = p[1], p[2]
            self.dist = np.zeros(0)
        elif model == "PINHOLE":
            self.fx, self.fy, self.cx, self.cy = p[:4]
            self.dist = np.zeros(0)
        elif model == "SIMPLE_RADIAL":
            self.fx = self.fy = p[0]
            self.cx, self.cy = p[1], p[2]
            self.dist = p[3:4]
        elif model == "RADIAL":
            self.fx = self.fy = p[0]
            self.cx, self.cy = p[1], p[2]
            self.dist = p[3:5]
        elif model == "OPENCV":
            self.fx, self.fy, self.cx, self.cy = p[:4]
            self.dist = p[4:8]
        else:
            raise ValueError(f"unsupported camera model {model}")

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )

    def distort(self, xn: np.ndarray) -> np.ndarray:
        """Apply the model's distortion to normalized coords [N, 2]."""
        if self.dist.size == 0:
            return xn
        x, y = xn[:, 0], xn[:, 1]
        r2 = x * x + y * y
        if self.model in ("SIMPLE_RADIAL", "RADIAL"):
            k1 = self.dist[0]
            k2 = self.dist[1] if self.dist.size > 1 else 0.0
            f = 1 + k1 * r2 + k2 * r2 * r2
            return np.stack([x * f, y * f], axis=1)
        # OPENCV: k1 k2 p1 p2
        k1, k2, p1, p2 = self.dist
        f = 1 + k1 * r2 + k2 * r2 * r2
        xd = x * f + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * f + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], axis=1)

    def undistort(self, xd: np.ndarray, iters: int = 20) -> np.ndarray:
        """Fixed-point undistortion, 20 iterations (ref ``scene_manager.py:66-72``)."""
        xn = xd.copy()
        for _ in range(iters):
            delta = self.distort(xn) - xn
            xn = xd - delta
        return xn

    def project(self, pts_cam: np.ndarray) -> np.ndarray:
        """Camera-frame points [N, 3] -> pixel coords [N, 2] (with distortion)."""
        xn = pts_cam[:, :2] / pts_cam[:, 2:3]
        xd = self.distort(xn)
        return np.stack(
            [self.fx * xd[:, 0] + self.cx, self.fy * xd[:, 1] + self.cy], axis=1
        )


class Image:
    def __init__(self, image_id, qvec, tvec, camera_id, name, points2D, point3D_ids):
        self.image_id = image_id
        self.qvec = qvec          # [4] (qw qx qy qz)
        self.tvec = tvec          # [3]
        self.camera_id = camera_id
        self.name = name
        self.points2D = points2D          # [M, 2]
        self.point3D_ids = point3D_ids    # [M] (-1 where untracked)

    @property
    def R(self) -> np.ndarray:
        return quaternion_to_matrix(self.qvec)

    @property
    def pose(self) -> np.ndarray:
        """World->camera 4x4."""
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.tvec
        return T

    @property
    def camera_center(self) -> np.ndarray:
        return -self.R.T @ self.tvec


class SceneManager:
    """Loads a COLMAP text model directory (cameras.txt / images.txt / points3D.txt)."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.name_to_image_id: Dict[str, int] = {}
        self.points3D: np.ndarray = np.zeros((0, 3))
        self.point3D_ids: np.ndarray = np.zeros(0, np.int64)
        self.point3D_colors: np.ndarray = np.zeros((0, 3), np.uint8)
        self.point3D_errors: np.ndarray = np.zeros(0)
        self.point3D_track_len: np.ndarray = np.zeros(0, np.int64)
        self._point3D_tracks: Dict[int, List[int]] = {}
        self._id_to_idx: Dict[int, int] = {}

    # -- loading -------------------------------------------------------------
    def load(self):
        self.load_cameras()
        self.load_images()
        self.load_points3D()
        return self

    def _lines(self, fname):
        with open(os.path.join(self.model_dir, fname)) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    yield line

    def load_cameras(self):
        for line in self._lines("cameras.txt"):
            tok = line.split()
            cam_id, model, w, h = int(tok[0]), tok[1], int(tok[2]), int(tok[3])
            self.cameras[cam_id] = Camera(model, w, h, [float(v) for v in tok[4:]])

    def load_images(self):
        it = self._lines("images.txt")
        for line in it:
            tok = line.split()
            image_id = int(tok[0])
            qvec = np.array([float(v) for v in tok[1:5]])
            tvec = np.array([float(v) for v in tok[5:8]])
            camera_id = int(tok[8])
            name = tok[9]
            try:
                track = next(it).split()
            except StopIteration:
                track = []
            xs = np.array([float(v) for v in track[0::3]])
            ys = np.array([float(v) for v in track[1::3]])
            ids = np.array([int(v) for v in track[2::3]], np.int64)
            img = Image(image_id, qvec, tvec, camera_id, name,
                        np.stack([xs, ys], axis=1) if xs.size else np.zeros((0, 2)), ids)
            self.images[image_id] = img
            self.name_to_image_id[name] = image_id

    def load_points3D(self):
        pts, ids, colors, errors, tracks = [], [], [], [], []
        for line in self._lines("points3D.txt"):
            tok = line.split()
            ids.append(int(tok[0]))
            pts.append([float(v) for v in tok[1:4]])
            colors.append([int(v) for v in tok[4:7]])
            errors.append(float(tok[7]))
            track_imgs = [int(v) for v in tok[8::2]]
            tracks.append(track_imgs)
        self.point3D_ids = np.array(ids, np.int64)
        self.points3D = np.array(pts) if pts else np.zeros((0, 3))
        self.point3D_colors = np.array(colors, np.uint8) if colors else np.zeros((0, 3), np.uint8)
        self.point3D_errors = np.array(errors)
        self.point3D_track_len = np.array([len(t) for t in tracks], np.int64)
        self._point3D_tracks = dict(zip(ids, tracks))
        self._id_to_idx = {pid: i for i, pid in enumerate(ids)}

    # -- queries (ref scene_manager.py:258-335) --------------------------------
    def get_points3D(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(3D points tracked in this image, their 2D observations)."""
        img = self.images[image_id]
        mask = img.point3D_ids >= 0
        valid = [
            (self._id_to_idx[pid], j)
            for j, pid in enumerate(img.point3D_ids)
            if pid >= 0 and pid in self._id_to_idx
        ]
        if not valid:
            return np.zeros((0, 3)), np.zeros((0, 2))
        idx3, idx2 = zip(*valid)
        return self.points3D[list(idx3)], img.points2D[list(idx2)]

    def get_viewed_points(self, image_id: int) -> np.ndarray:
        """All model points that project inside this image's frustum with z > 0."""
        img = self.images[image_id]
        cam = self.cameras[img.camera_id]
        pts_cam = (img.R @ self.points3D.T).T + img.tvec
        front = pts_cam[:, 2] > 0
        pix = np.zeros((len(pts_cam), 2))
        pix[front] = cam.project(pts_cam[front])
        inside = (
            front
            & (pix[:, 0] >= 0) & (pix[:, 0] < cam.width)
            & (pix[:, 1] >= 0) & (pix[:, 1] < cam.height)
        )
        return self.points3D[inside]

    def filter_points3D(self, min_track_len: int = 3, max_error: float = 2.0,
                        min_tri_angle_deg: float = 1.5) -> np.ndarray:
        """Quality mask over points: track length, reprojection error, triangulation
        angle (max pairwise baseline angle across the track's camera centers)."""
        keep = (self.point3D_track_len >= min_track_len) & (
            self.point3D_errors <= max_error
        )
        centers = {i: im.camera_center for i, im in self.images.items()}
        cos_min = np.cos(np.deg2rad(min_tri_angle_deg))
        for i, pid in enumerate(self.point3D_ids):
            if not keep[i]:
                continue
            track = [t for t in self._point3D_tracks.get(pid, []) if t in centers]
            if len(track) < 2:
                keep[i] = False
                continue
            X = self.points3D[i]
            rays = np.stack([centers[t] - X for t in track])
            rays /= np.linalg.norm(rays, axis=1, keepdims=True) + 1e-12
            cos = rays @ rays.T
            np.fill_diagonal(cos, 1.0)
            keep[i] = cos.min() <= cos_min
        return keep
