"""The port's copy of the COLMAP tooling and 3D / flow I/O against the JAX package's:
``SceneManager``'s fields and queries on a text model, ``Camera``'s models, the flow and
PFM readers, the NumPy bilinear sampler, the rotation converters, the depth geometry and
the writers (byte-identical files).
"""
import filecmp

import numpy as np
import pytest

from torch_fixtures import drop_tmp_path  # noqa: F401 (fixture)
from tf_depth_estimation_torch import colmap
from tf_depth_estimation_torch.colmap import io
from tf_depth_estimation_torch.data.synthetic import write_colmap_pair


def _model(tmp_path):
    """A text model of 3 images (one untracked observation, a point seen twice) and 6
    points, written by ``write_colmap_pair`` and extended."""
    scene = write_colmap_pair(str(tmp_path), H=32, W=48, num_points=6, seed=9)
    d = scene["model_dir"]
    with open(f"{d}/images.txt", "a") as f:
        f.write("3 0.99 0.01 -0.02 0.1 0.4 -0.1 0.2 1 c.jpg\n")
        f.write("5.0 6.0 -1 7.5 8.5 3 9.0 1.0 4\n")
    with open(f"{d}/points3D.txt") as f:
        lines = f.read().splitlines()
    lines = [l + " 3 1" if l.split()[0] == "3" else l for l in lines]
    with open(f"{d}/points3D.txt", "w") as f:
        f.write("# a comment\n" + "\n".join(lines) + "\n")
    return d


def test_scene_manager_equals_jax(tmp_path):
    from tf_depth_estimation_tpu.colmap import SceneManager as JSceneManager

    d = _model(tmp_path)
    got, ref = colmap.SceneManager(d).load(), JSceneManager(d).load()
    assert got.name_to_image_id == ref.name_to_image_id == {"a.jpg": 1, "b.jpg": 2,
                                                            "c.jpg": 3}
    for name in ("points3D", "point3D_ids", "point3D_colors", "point3D_errors",
                 "point3D_track_len"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert got._point3D_tracks == ref._point3D_tracks
    for i, im in ref.images.items():
        g = got.images[i]
        assert (g.name, g.camera_id) == (im.name, im.camera_id)
        for attr in ("qvec", "tvec", "points2D", "point3D_ids", "R", "pose",
                     "camera_center"):
            np.testing.assert_array_equal(getattr(g, attr), getattr(im, attr), err_msg=attr)
        for a, b in zip(got.get_points3D(i), ref.get_points3D(i)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.get_viewed_points(i), ref.get_viewed_points(i))
    for kw in ({}, {"min_track_len": 2, "max_error": 1.0, "min_tri_angle_deg": 0.1}):
        np.testing.assert_array_equal(got.filter_points3D(**kw), ref.filter_points3D(**kw))
    np.testing.assert_array_equal(got.cameras[1].K, ref.cameras[1].K)


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_PINHOLE", [40.0, 24.0, 16.0]), ("PINHOLE", [40.0, 42.0, 24.0, 16.0]),
    ("SIMPLE_RADIAL", [40.0, 24.0, 16.0, 0.05]),
    ("RADIAL", [40.0, 24.0, 16.0, 0.05, -0.01]),
    ("OPENCV", [40.0, 42.0, 24.0, 16.0, 0.05, -0.01, 0.002, -0.001])])
def test_camera_models_equal_jax(model, params):
    from tf_depth_estimation_tpu.colmap import Camera as JCamera

    rng = np.random.RandomState(1)
    xn = rng.uniform(-0.4, 0.4, (20, 2))
    pts = np.concatenate([xn * 2.0, np.full((20, 1), 2.0)], 1)
    got, ref = colmap.Camera(model, 48, 32, params), JCamera(model, 48, 32, params)
    for a, b in ((got.K, ref.K), (got.distort(xn), ref.distort(xn)),
                 (got.undistort(xn), ref.undistort(xn)),
                 (got.project(pts), ref.project(pts))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        colmap.Camera("FISHEYE", 48, 32, params)


def _write_flo(path, flow):
    with open(path, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def _write_pfm(path, data, scale):
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n{scale}\n".encode())
        np.flipud(data).astype("<f4" if scale < 0 else ">f4").tofile(f)


def test_flow_and_pfm_readers_equal_jax(tmp_path):
    """``.flo``, a 3-channel PFM (little-endian) as flow, a 1-channel PFM (big-endian),
    and the refusal of a file of another kind."""
    from tf_depth_estimation_tpu.colmap import io as jio

    rng = np.random.RandomState(2)
    flow = rng.uniform(-4, 4, (5, 7, 2)).astype(np.float32)
    _write_flo(tmp_path / "a.flo", flow)
    _write_pfm(tmp_path / "b.pfm", rng.rand(5, 7, 3).astype(np.float32), -1.0)
    _write_pfm(tmp_path / "c.pfm", rng.rand(4, 6).astype(np.float32), 2.0)
    got = io.read_flow(str(tmp_path / "a.flo"))
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(got, jio.read_flow(str(tmp_path / "a.flo")))
    np.testing.assert_array_equal(io.read_flow(str(tmp_path / "b.pfm")),
                                  jio.read_flow(str(tmp_path / "b.pfm")))
    pfm = str(tmp_path / "c.pfm")
    (d, s), (jd, js) = io.read_pfm(pfm), jio.read_pfm(pfm)
    assert s == js == 2.0 and d.shape == (4, 6, 1)
    np.testing.assert_array_equal(d, jd)
    (tmp_path / "bad.flo").write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        io.read_flow(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_interpolate_equals_jax(channels):
    """Taps clamped to the border, coordinates inside and outside the image."""
    from tf_depth_estimation_tpu.colmap import io as jio

    rng = np.random.RandomState(3)
    im = rng.rand(6, 9) if channels is None else rng.rand(6, 9, channels)
    x, y = rng.uniform(-2, 11, (4, 5)), rng.uniform(-2, 8, (4, 5))
    got = io.bilinear_interpolate(im, x, y)
    assert got.shape == (4, 5) + (() if channels is None else (channels,))
    np.testing.assert_array_equal(got, jio.bilinear_interpolate(im, x, y))


def test_rotations_and_depth_geometry_equal_jax():
    from tf_depth_estimation_tpu.colmap import io as jio

    rng = np.random.RandomState(4)
    q = rng.randn(4)
    np.testing.assert_array_equal(io.quaternion_to_matrix(q), jio.quaternion_to_matrix(q))
    np.testing.assert_array_equal(io.quaternion_to_matrix(np.zeros(4)), np.eye(3))
    R = io.axis_angle_to_matrix_np([0.3, -0.2, 0.9], 0.7)
    np.testing.assert_array_equal(R, jio.axis_angle_to_matrix_np([0.3, -0.2, 0.9], 0.7))
    for a, b in zip(io.matrix_to_axis_angle_np(R), jio.matrix_to_axis_angle_np(R)):
        np.testing.assert_array_equal(a, b)
    assert io.matrix_to_axis_angle_np(np.eye(3))[1] == 0.0
    depth = rng.uniform(1, 2, (7, 9))
    K = np.array([[10.0, 0, 4.5], [0, 10.0, 3.5], [0, 0, 1]])
    n = io.normals_from_depth(depth, K)
    np.testing.assert_array_equal(n, jio.normals_from_depth(depth, K))
    np.testing.assert_array_equal(io.shading_from_normals(n), jio.shading_from_normals(n))


def test_writers_give_byte_identical_files(tmp_path):
    """XYZ, PLY points (with and without colours), PLY and WRL surfaces."""
    from tf_depth_estimation_tpu.colmap import io as jio

    rng = np.random.RandomState(5)
    pts = rng.randn(6, 3)
    colors = rng.randint(0, 256, (6, 3))
    depth = rng.uniform(1, 2, (5, 7))
    K = np.array([[8.0, 0, 3.5], [0, 8.0, 2.5], [0, 0, 1]])
    cases = {"p.xyz": ("write_xyz", (pts,)), "p.ply": ("write_ply_points", (pts,)),
             "pc.ply": ("write_ply_points", (pts, colors)),
             "s.ply": ("write_ply_surface", (depth, K)),
             "s2.ply": ("write_ply_surface", (depth, K, 2)),
             "s.wrl": ("write_wrl_surface", (depth, K))}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for name, (fn, args) in cases.items():
        getattr(io, fn)(str(tmp_path / "port" / name), *args)
        getattr(jio, fn)(str(tmp_path / "jax" / name), *args)
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
