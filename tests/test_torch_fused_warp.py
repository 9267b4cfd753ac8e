"""The port's fused warp sampler (``ops/bilinear_sample_fused.py``) against the JAX
package's ``bilinear_sample_fused`` (its Pallas kernel in interpret mode, or its plain
fallback), on the inputs of ``tests/test_pallas.py:23-50``: the forward, both gradients,
the fallback, a same-product non-square warp and the eligibility rule. The ``cuda`` tests
hold the CUDA kernels to the plain version on the card, as ``chip_smoke.py`` does.

JAX is imported inside the tests that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.geometry.sampling import bilinear_sample as routed_sample
from tf_depth_estimation_torch.geometry.warp import projective_inverse_warp
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.ops import bilinear_sample_fused as bsf

# tests/test_pallas.py's limits: the forward at atol 1e-6, the gradients at atol 1e-5
TOL_FWD, TOL_GRAD = 1e-6, 1e-5


def _pallas_inputs():
    """The arrays of tests/test_pallas.py:23-50, drawn from RandomState(21) in its order:
    the forward case, the gradient case, the B=3 fallback case."""
    rng = np.random.RandomState(21)
    fwd = (rng.rand(8, 16, 24, 3).astype(np.float32),
           rng.uniform(-3, 27, (8, 16, 24, 2)).astype(np.float32))
    grad = (rng.rand(8, 8, 16, 1).astype(np.float32),
            rng.uniform(0, 14, (8, 8, 16, 2)).astype(np.float32))
    fallback = (rng.rand(3, 8, 8, 1).astype(np.float32),
                rng.uniform(0, 7, (3, 8, 8, 2)).astype(np.float32))
    return {"fwd": fwd, "grad": grad, "fallback": fallback}


def _non_square(seed=22):
    """A 16x24 image sampled at 24x16 coords: the same product, so eligible in JAX."""
    rng = np.random.RandomState(seed)
    return (rng.rand(8, 16, 24, 3).astype(np.float32),
            rng.uniform(-3, 27, (8, 24, 16, 2)).astype(np.float32))


def _jax_fused(imgs, coords):
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_warp import bilinear_sample_fused

    out, mask = bilinear_sample_fused(jnp.asarray(imgs), jnp.asarray(coords), True)
    return np.asarray(out), np.asarray(mask)


def _counts():
    return (bsf.bilinear_sample_fused.launches, bsf.bilinear_sample_fused.backward_launches,
            bs.bilinear_sample.launches)


@pytest.mark.parametrize("case", ["fwd", "non_square"])
def test_forward_matches_jax_interpret_kernel(case):
    """On a CPU tensor the port runs the plain version; JAX runs its Pallas kernel in
    interpret mode (both cases are eligible)."""
    imgs, coords = _non_square() if case == "non_square" else _pallas_inputs()["fwd"]
    before = _counts()
    out, mask = bsf.bilinear_sample_fused(torch.from_numpy(imgs), torch.from_numpy(coords))
    assert _counts() == before              # only kernel launches count
    ref_out, ref_mask = _jax_fused(imgs, coords)
    assert out.shape == ref_out.shape and mask.shape == ref_mask.shape
    np.testing.assert_allclose(out.numpy(), ref_out, atol=TOL_FWD)
    np.testing.assert_allclose(mask.numpy(), ref_mask, atol=TOL_FWD)


@pytest.mark.parametrize("case", ["grad", "non_square"])
def test_gradients_match_jax(case):
    """d/d imgs and d/d coords of sum(out ** 2), as tests/test_pallas.py:34-43 takes
    them; JAX's backward is autodiff of its plain sampler."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_warp import bilinear_sample_fused

    imgs, coords = _non_square() if case == "non_square" else _pallas_inputs()["grad"]
    ref = jax.grad(lambda i, c: jnp.sum(bilinear_sample_fused(i, c, True)[0] ** 2),
                   argnums=(0, 1))(jnp.asarray(imgs), jnp.asarray(coords))
    ti = torch.from_numpy(imgs).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    (bsf.bilinear_sample_fused(ti, tc)[0] ** 2).sum().backward()
    for got, want in zip((ti.grad, tc.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_GRAD)


def test_fallback_batch_matches_jax():
    """B=3 is outside the rule: JAX falls back to its plain sampler, as the port does."""
    imgs, coords = _pallas_inputs()["fallback"]
    assert not bsf._supported(torch.from_numpy(imgs), torch.from_numpy(coords))
    out, mask = bsf.bilinear_sample_fused(torch.from_numpy(imgs), torch.from_numpy(coords))
    ref_out, ref_mask = _jax_fused(imgs, coords)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=TOL_FWD)
    np.testing.assert_allclose(mask.numpy(), ref_mask, atol=TOL_FWD)


# (B, Hs, Ws, Ht, Wt): eligible and not, by each clause of the rule
RULE_SHAPES = [(8, 16, 24, 16, 24), (8, 16, 24, 24, 16), (16, 192, 256, 192, 256),
               (8, 16, 24, 16, 25), (3, 8, 8, 8, 8), (10, 224, 480, 224, 480),
               (8, 512, 256, 512, 256), (8, 512, 257, 512, 257), (0, 4, 4, 4, 4)]


@pytest.mark.parametrize("shape", RULE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_eligibility_rule_is_jaxs(shape):
    from tf_depth_estimation_tpu.ops.pallas_warp import _supported

    B, Hs, Ws, Ht, Wt = shape
    imgs, coords = np.zeros((B, Hs, Ws, 3), np.float32), np.zeros((B, Ht, Wt, 2), np.float32)
    assert bsf._supported(torch.from_numpy(imgs), torch.from_numpy(coords)) == \
        _supported(imgs, coords)


def test_sampler_name_fused_routes_here_and_runs_the_plain_version_on_cpu():
    imgs, coords = (torch.from_numpy(a) for a in _pallas_inputs()["fwd"])
    before, calls = _counts(), bs.bilinear_sample_reference.calls
    out, mask = routed_sample(imgs, coords, sampler="fused")
    ref_out, ref_mask = bs.bilinear_sample_reference(imgs, coords)
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
    assert _counts() == before and bs.bilinear_sample_reference.calls == calls + 2


def test_views_are_made_contiguous():
    """The warps may hand the sampler views: a transposed image and coordinates give what
    their contiguous copies give."""
    imgs, coords = (torch.from_numpy(a) for a in _pallas_inputs()["fwd"])
    view_i = imgs.transpose(1, 2).contiguous().transpose(1, 2)
    view_c = torch.stack([coords[..., 0], coords[..., 1]], 0).permute(1, 2, 3, 0)
    assert not view_i.is_contiguous() and not view_c.is_contiguous()
    for got, want in zip(bsf.bilinear_sample_fused(view_i, view_c),
                         bsf.bilinear_sample_fused(imgs, coords)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["imgs_f64", "coords_bf16", "coords_shape", "batch"])
def test_rejects_what_the_kernels_do_not_take(case):
    imgs, coords = (torch.from_numpy(a) for a in _pallas_inputs()["fwd"])
    bad = {"imgs_f64": (imgs.double(), coords),
           "coords_bf16": (imgs, coords.to(torch.bfloat16)),
           "coords_shape": (imgs, coords[..., :1]), "batch": (imgs[:1], coords)}[case]
    with pytest.raises((ValueError, TypeError)):
        bsf.bilinear_sample_fused(*bad)


# ---- on the card -----------------------------------------------------------------------

# dcoords and dimgs against autograd of the plain version: the same terms, the channels
# and the scattered taps summed in another order; the limit of bilinear_sample's own
# backward (chip_smoke.py TOL_DCOORDS), on images in [0, 255]
TOL_CUDA_GRAD = dict(rtol=1e-5, atol=1e-5 * 255)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def euler_coords(B, H, W, seed=0):
    """The coords of config 3's warp: a seeded depth in [0.8, 2.5] and an Euler pose of up
    to 5 cm and 0.02 rad, DeMoN-like intrinsics."""
    rng = np.random.RandomState(seed)
    depth = torch.from_numpy(rng.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    pose = torch.from_numpy(np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)),
                                            rng.uniform(-0.02, 0.02, (B, 3))], -1)
                            .astype(np.float32))
    K = torch.tensor([[0.89 * W, 0, W / 2], [0, 1.19 * H, H / 2], [0, 0, 1]]).expand(B, 3, 3)
    img = torch.zeros((B, H, W, 1))
    return projective_inverse_warp(img, depth, pose, K.contiguous(), fmt="euler").coords


def _cuda_case(name):
    """(imgs in [0, 255], coords) on the CPU for the card's checks."""
    rng = np.random.RandomState(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if name.startswith("config3"):
        s = int(name[-1])
        h, w = 192 >> s, 256 >> s
        return t(rng.rand(16, h, w, 3) * 255), euler_coords(16, h, w, seed=s).contiguous()
    if name == "non_square":
        return t(rng.rand(16, 16, 24, 3) * 255), t(rng.uniform(-3, 27, (16, 24, 16, 2)))
    if name == "borders":       # halves and integers reaching past every border
        return t(rng.rand(8, 12, 20, 3) * 255), t(np.round(rng.uniform(
            [-2.5, -2.5], [22.5, 14.5], (8, 12, 20, 2)) * 2) / 2)
    coords = rng.uniform(-2, 14, (8, 12, 20, 2))            # "nonfinite"
    coords.reshape(-1)[rng.choice(coords.size, 60, replace=False)] = np.repeat(
        [np.nan, np.inf, -np.inf], 20)
    return t(rng.rand(8, 12, 20, 3) * 255), t(coords)


CUDA_CASES = ["config3 s0", "config3 s1", "config3 s2", "config3 s3", "non_square",
              "borders", "nonfinite"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CUDA_CASES)
def test_cuda_forward_is_bit_equal_to_plain(name):
    dev = _cuda()
    imgs, coords = (a.to(dev) for a in _cuda_case(name))
    before = _counts()
    out, mask = bsf.bilinear_sample_fused(imgs, coords)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2])
    ref_out, ref_mask = bs.bilinear_sample_reference(imgs, coords)
    for got, want in ((out, ref_out), (mask, ref_mask)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CUDA_CASES)
def test_cuda_backward_matches_autograd_of_plain(name):
    """dcoords and dimgs against autograd of the plain version, with a cotangent for
    out and wmask; dcoords twice gives the same bits."""
    dev = _cuda()
    imgs, coords = (a.to(dev) for a in _cuda_case(name))
    rng = np.random.RandomState(6)
    dout = torch.from_numpy(rng.randn(*coords.shape[:3], 3).astype(np.float32)).to(dev)
    dmask = torch.from_numpy(rng.randn(*coords.shape[:3], 1).astype(np.float32)).to(dev)
    grads = []
    for fn in (bsf.bilinear_sample_fused, bsf.bilinear_sample_fused,
               bs.bilinear_sample_reference):
        ti, tc = imgs.clone().requires_grad_(True), coords.clone().requires_grad_(True)
        before = bsf.bilinear_sample_fused.backward_launches
        torch.autograd.backward(list(fn(ti, tc)), [dout, dmask])
        torch.cuda.synchronize()
        if fn is bsf.bilinear_sample_fused:
            assert bsf.bilinear_sample_fused.backward_launches == before + 1
        grads.append((ti.grad, tc.grad))
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=0, equal_nan=True)
    for got, want in zip(grads[0], grads[2]):
        torch.testing.assert_close(got, want, equal_nan=True, **TOL_CUDA_GRAD)


@pytest.mark.cuda
def test_cuda_without_a_wmask_gradient():
    """Config 3 reads only out: the backward runs with no wmask cotangent and gives
    autograd's dcoords of the plain version."""
    dev = _cuda()
    imgs, coords = (a.to(dev) for a in _cuda_case("config3 s2"))
    grads = []
    for fn in (bsf.bilinear_sample_fused, bs.bilinear_sample_reference):
        tc = coords.clone().requires_grad_(True)
        (fn(imgs, tc)[0] ** 2).mean().backward()
        grads.append(tc.grad)
    torch.testing.assert_close(grads[0], grads[1], **TOL_CUDA_GRAD)


@pytest.mark.cuda
def test_cuda_ineligible_batch_launches_the_sampler_kernel():
    dev = _cuda()
    rng = np.random.RandomState(7)
    imgs = torch.from_numpy((rng.rand(10, 24, 32, 3) * 255).astype(np.float32)).to(dev)
    coords = euler_coords(10, 24, 32).to(dev)
    before = _counts()
    out, mask = bsf.bilinear_sample_fused(imgs, coords)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 1)
    ref_out, ref_mask = bs.bilinear_sample_reference(imgs, coords)
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
