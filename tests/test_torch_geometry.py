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


@pytest.mark.parametrize("fmt", ["quaternion"])
def test_other_pose_formats_are_refused(fmt):
    """A pose format the JAX package lacks is refused."""
    img, depth, K, pose = _t(*_scene())
    with pytest.raises(ValueError):
        warp.projective_inverse_warp(img, depth, pose[:, :2, :3].reshape(2, 6), K, fmt=fmt)


@pytest.mark.parametrize("fmt", ["euler", "angleaxis"])
def test_vector_pose_formats_warp_as_jax(fmt):
    """The 6-vector pose formats warp as JAX's do."""
    img, depth, K, pose = _scene()
    vec = np.random.RandomState(3).uniform(-0.1, 0.1, (2, 6)).astype(np.float32)
    ref = jwarp.projective_inverse_warp(jnp.asarray(img), jnp.asarray(depth),
                                        jnp.asarray(vec), jnp.asarray(K), fmt=fmt)
    got = warp.projective_inverse_warp(*_t(img, depth, vec, K), fmt=fmt)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), **TOL)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image), rtol=1e-4,
                               atol=5e-3)


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


# ---- rotations, poses and the depth consistency (split_training) -----------------------

from tf_depth_estimation_tpu.geometry import pose as jpose  # noqa: E402
from tf_depth_estimation_tpu.geometry import rotations as jrot  # noqa: E402
from tf_depth_estimation_torch.geometry import pose, rotations  # noqa: E402


def _angles(seed=4, n=6):
    """Angles in [-4, 4] (past +-pi, which euler_to_matrix clips), and rotation vectors
    with one exactly 0 and one of about 1e-7 rad."""
    rng = np.random.RandomState(seed)
    zyx = rng.uniform(-4, 4, (3, n)).astype(np.float32)
    rotvec = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    rotvec[0], rotvec[1] = 0.0, [1e-7, 0, 0]
    return zyx, rotvec


def test_rotations_match_jax():
    zyx, rotvec = _angles()
    np.testing.assert_allclose(rotations.euler_to_matrix(*_t(*zyx)).numpy(),
                               np.asarray(jrot.euler_to_matrix(*zyx)), rtol=1e-6, atol=1e-6)
    axis = rotvec[2:] / np.linalg.norm(rotvec[2:], axis=-1, keepdims=True)
    angle = np.linalg.norm(rotvec[2:], axis=-1)
    np.testing.assert_allclose(rotations.axis_angle_to_matrix(*_t(axis, angle)).numpy(),
                               np.asarray(jrot.axis_angle_to_matrix(axis, angle)),
                               rtol=1e-6, atol=1e-6)
    R = rotations.rotvec_to_matrix(torch.from_numpy(rotvec))
    np.testing.assert_allclose(R.numpy(), np.asarray(jrot.rotvec_to_matrix(rotvec)),
                               rtol=1e-6, atol=1e-6)
    for got, ref in zip(rotations.matrix_to_axis_angle(R),
                        jrot.matrix_to_axis_angle(jnp.asarray(R.numpy()))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_rotvec_gradient_matches_jax_at_zero_and_elsewhere():
    """The double ``where`` keeps the gradient finite at a zero rotation vector, as JAX's
    does: the gradient of sum(w * R) at v = 0 and at ordinary v."""
    import jax

    _, rotvec = _angles()
    w = np.random.RandomState(5).randn(len(rotvec), 3, 3).astype(np.float32)
    v = torch.from_numpy(rotvec).requires_grad_(True)
    (rotations.rotvec_to_matrix(v) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda a: (jrot.rotvec_to_matrix(a) * w).sum())(jnp.asarray(rotvec))
    assert np.isfinite(v.grad.numpy()).all()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["euler", "angleaxis", "identity"])
def test_pose_vec_to_mat_and_inverse_match_jax(fmt):
    vec = np.random.RandomState(6).uniform(-1, 1, (4, 6)).astype(np.float32)
    T = pose.pose_vec_to_mat(torch.from_numpy(vec), fmt)
    ref = jpose.pose_vec_to_mat(jnp.asarray(vec), fmt)
    np.testing.assert_allclose(T.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    inv = pose.invert_transform(T)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jpose.invert_transform(ref)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((T @ inv).numpy(), np.tile(np.eye(4), (4, 1, 1)), atol=1e-6)


@pytest.mark.parametrize("sampler", ["xla", "pallas"])
def test_resample_depth_and_consistent_depth_error(sampler):
    img, depth, K, mat = _scene(seed=7)
    rng = np.random.RandomState(8)
    inv_depth = rng.uniform(0.4, 1.25, (2, 16, 24, 1)).astype(np.float32)
    ref_warp = jwarp.projective_inverse_warp(jnp.asarray(img), jnp.asarray(depth),
                                             jnp.asarray(mat), jnp.asarray(K), fmt="matrix")
    warped = warp.projective_inverse_warp(*_t(img, depth, mat, K), fmt="matrix")
    np.testing.assert_allclose(
        warp.resample_depth(torch.from_numpy(inv_depth), warped.coords, sampler).numpy(),
        np.asarray(jwarp.resample_depth(inv_depth, ref_warp.coords)), rtol=1e-5, atol=1e-5)
    got = warp.consistent_depth_error(torch.from_numpy(inv_depth), warped.warped_depth,
                                      warped.coords, sampler=sampler)
    ref = jwarp.consistent_depth_error(inv_depth, ref_warp.warped_depth, ref_warp.coords)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
