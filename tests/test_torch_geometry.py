"""The port's camera, warp and flow functions against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.geometry import camera as jcamera
from tf_depth_estimation_tpu.geometry import warp as jwarp
from tf_depth_estimation_torch.geometry import camera, warp

# float32: the projection sums four products in another order than XLA's einsum, and the
# division by z (~1) keeps the error relative; coordinates reach ~100 pixels here
TOL = dict(rtol=1e-5, atol=1e-4)


def _scene(B=2, H=16, W=24, seed=0):
    """Image [B,H,W,3] in [0, 255], depth [B,H,W], K [B,3,3], pose [B,4,4]; numpy."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    depth = rng.uniform(0.8, 2.5, (B, H, W)).astype(np.float32)
    K = np.tile(np.array([[0.9 * W, 0.1, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    angle = rng.uniform(-0.05, 0.05, B)
    pose[:, 0, 0] = pose[:, 1, 1] = np.cos(angle)
    pose[:, 0, 1], pose[:, 1, 0] = -np.sin(angle), np.sin(angle)
    pose[:, :3, 3] = rng.uniform(-0.1, 0.1, (B, 3))
    return img, depth, K, pose


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("homogeneous", [True, False])
def test_pixel_grid(homogeneous):
    np.testing.assert_array_equal(camera.pixel_grid(5, 7, homogeneous).numpy(),
                                  np.asarray(jcamera.pixel_grid(5, 7, homogeneous)))


def test_pixel_to_cam_and_cam_to_pixel():
    _, depth, K, pose = _scene()
    pts = jcamera.pixel_to_cam(jnp.asarray(depth), jnp.asarray(K))
    got = camera.pixel_to_cam(*_t(depth, K))
    np.testing.assert_allclose(got.numpy(), np.asarray(pts), rtol=1e-6, atol=1e-6)
    proj = np.asarray(jcamera.pad_intrinsics_4x4(jnp.asarray(K))) @ pose
    ref_c, ref_z = jcamera.cam_to_pixel(pts, jnp.asarray(proj))
    c, z = camera.cam_to_pixel(got, torch.from_numpy(proj))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), **TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), **TOL)


def test_cam_to_pixel_guards_z_zero():
    pts = torch.zeros(1, 4, 1, 2)
    pts[0, 0], pts[0, 3] = 1.0, 1.0
    coords, _ = camera.cam_to_pixel(pts, torch.eye(4)[None])
    ref, _ = jcamera.cam_to_pixel(jnp.asarray(pts.numpy()), jnp.eye(4)[None])
    np.testing.assert_array_equal(coords.numpy(), np.asarray(ref))   # 1 / 1e-10


def test_pad_intrinsics_and_f32_matmul():
    _, _, K, pose = _scene()
    K4 = camera.pad_intrinsics_4x4(torch.from_numpy(K))
    np.testing.assert_array_equal(K4.numpy(), np.asarray(jcamera.pad_intrinsics_4x4(K)))
    np.testing.assert_allclose(camera.matmul_f32(K4, torch.from_numpy(pose)).numpy(),
                               K4.numpy() @ pose, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("sampler", ["xla", "pallas"])
def test_projective_inverse_warp_matrix(sampler):
    img, depth, K, pose = _scene()
    ref = jwarp.projective_inverse_warp(jnp.asarray(img), jnp.asarray(depth),
                                        jnp.asarray(pose), jnp.asarray(K), fmt="matrix")
    got = warp.projective_inverse_warp(*_t(img, depth, pose, K), fmt="matrix",
                                       sampler=sampler)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), **TOL)
    np.testing.assert_allclose(got.warped_depth.numpy(), np.asarray(ref.warped_depth),
                               **TOL)
    # a coordinate that moved by 1e-5 moves a [0, 255] sample by up to ~3e-3
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image), rtol=1e-4,
                               atol=5e-3)
    np.testing.assert_allclose(got.mask.numpy(), np.asarray(ref.mask), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fmt", ["euler", "angleaxis", "quaternion"])
def test_other_pose_formats_are_refused(fmt):
    img, depth, K, pose = _t(*_scene())
    with pytest.raises((NotImplementedError, ValueError)):
        warp.projective_inverse_warp(img, depth, pose[:, :2, :3].reshape(2, 6), K, fmt=fmt)


@pytest.mark.parametrize("sampler", ["xla", "pallas"])
def test_flow_warp_and_flow_from_coords(sampler):
    img, depth, K, pose = _scene(seed=1)
    rng = np.random.RandomState(2)
    fx, fy = (rng.randn(2, 16, 24, 1) * 2).astype(np.float32), \
        (rng.randn(2, 16, 24, 1) * 2).astype(np.float32)
    ref = jwarp.flow_warp(jnp.asarray(img), jnp.asarray(fx), jnp.asarray(fy))
    got = warp.flow_warp(*_t(img, fx, fy), sampler=sampler)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)
    coords = (rng.rand(2, 16, 24, 2) * 30).astype(np.float32)
    for g, r in zip(warp.flow_from_coords(torch.from_numpy(coords)),
                    jwarp.flow_from_coords(jnp.asarray(coords))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
