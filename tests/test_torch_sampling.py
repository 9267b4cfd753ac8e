"""The port's bilinear sampler against the JAX package's (the XLA-gather sampler and the
Pallas kernel in interpret mode), its backward against ``jax.vjp``, and the CUDA kernel
against the port's plain version.

JAX is imported inside the tests that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.geometry.sampling import bilinear_sample as routed_sample
from tf_depth_estimation_torch.ops import bilinear_sample as bs

# float32 on images in [0, 1]: the limits of tests/test_pallas_sample.py. The port
# computes every product and sum in the reference's order, so the forward is usually
# exact; the backward sums the four corners' terms in another order than autodiff.
TOL_FWD = dict(rtol=1e-6, atol=1e-6)
TOL_VJP = dict(rtol=1e-5, atol=1e-5)


def _case(name, seed=0):
    """(imgs [B,Hs,Ws,C], coords [B,Ht,Wt,2]) numpy float32, images in [0, 1]."""
    rng = np.random.RandomState(seed)
    shapes = {"jitter": (2, 16, 64, 3, 16, 64), "wild": (2, 16, 40, 2, 16, 40),
              "border": (1, 16, 24, 1, 16, 24), "integer": (2, 8, 12, 3, 8, 12),
              "odd_size": (2, 13, 37, 3, 9, 21), "lane_unaligned": (2, 24, 160, 2, 24, 160)}
    B, Hs, Ws, C, Ht, Wt = shapes[name]
    imgs = rng.rand(B, Hs, Ws, C).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(Ht), np.arange(Wt), indexing="ij")
    grid = np.broadcast_to(np.stack([gx, gy], -1)[None], (B, Ht, Wt, 2)).astype(np.float32)
    if name in ("jitter", "lane_unaligned"):
        coords = grid + rng.randn(B, Ht, Wt, 2).astype(np.float32) * 3.0
    elif name == "wild":        # far outside the image as well as inside
        coords = (rng.rand(B, Ht, Wt, 2) * np.array([Ws * 4.0, Hs * 4.0]) - 2.0 * np.array(
            [Ws, Hs])).astype(np.float32)
    elif name == "border":      # straddling every border, as tests/test_pallas_sample.py
        coords = grid + np.array([-2.5, 2.5], np.float32)
        coords[:, :4, :, 1] -= 5.0
        coords[:, :, -3:, 0] += 4.25
    elif name == "integer":     # exact integers: floor is the identity, weights 1 and 0
        coords = grid + rng.randint(-3, 4, (B, Ht, Wt, 2)).astype(np.float32)
    else:                       # odd, non-square source and target sizes
        coords = rng.rand(B, Ht, Wt, 2).astype(np.float32) * np.array(
            [Ws + 2.0, Hs + 2.0], np.float32) - 1.0
    return imgs, np.ascontiguousarray(coords, dtype=np.float32)


CASES = ["jitter", "wild", "border", "integer", "odd_size", "lane_unaligned"]


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jnp_sampler(name):
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.geometry.sampling import _bilinear_sample_jnp

    imgs, coords = _case(name)
    ref_out, ref_mask = _bilinear_sample_jnp(jnp.asarray(imgs), jnp.asarray(coords))
    out, mask = bs.bilinear_sample_reference(*_torch(imgs, coords))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL_FWD)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("name", ["jitter", "wild", "border", "lane_unaligned"])
def test_wrapper_on_cpu_matches_pallas_interpret_kernel(name):
    """The kernel's own contract: same-size warps with Hs % 8 == 0, any width."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_sample import _sample_banded

    imgs, coords = _case(name)
    ref_out, ref_mask, _ = _sample_banded(jnp.asarray(imgs), jnp.asarray(coords),
                                          interpret=True)
    before = bs.bilinear_sample.launches
    out, mask = bs.bilinear_sample(*_torch(imgs, coords))
    assert bs.bilinear_sample.launches == before       # only kernel launches count
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL_FWD)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


def _cotangents(imgs, coords, seed=7):
    rng = np.random.RandomState(seed)
    B, Ht, Wt, _ = coords.shape
    return (rng.randn(B, Ht, Wt, imgs.shape[-1]).astype(np.float32),
            rng.randn(B, Ht, Wt, 1).astype(np.float32))


@pytest.mark.parametrize("name", ["jitter", "border", "integer", "lane_unaligned"])
def test_backward_matches_jax_vjp_of_pallas_sampler(name):
    import jax
    import jax.numpy as jnp
    from test_pallas_sample import pltpu_interpret

    from tf_depth_estimation_tpu.ops.pallas_sample import bilinear_sample_tpu

    imgs, coords = _case(name)   # each a same-size warp with Hs % 8 == 0, as it needs
    dout, dmask = _cotangents(imgs, coords)
    with pltpu_interpret():
        _, vjp = jax.vjp(bilinear_sample_tpu, jnp.asarray(imgs), jnp.asarray(coords))
        ref_di, ref_dc = vjp((jnp.asarray(dout), jnp.asarray(dmask)))
    ti, tc = _torch(imgs, coords, grad=True)
    out, mask = bs.bilinear_sample(ti, tc)
    torch.autograd.backward([out, mask], [torch.from_numpy(dout), torch.from_numpy(dmask)])
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(ref_dc), **TOL_VJP)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(ref_di), **TOL_VJP)


@pytest.mark.parametrize("name", CASES)
def test_backward_matches_autograd_of_plain_version(name):
    imgs, coords = _case(name)
    dout, dmask = _cotangents(imgs, coords)
    grads = []
    for fn in (bs.bilinear_sample, bs.bilinear_sample_reference):
        ti, tc = _torch(imgs, coords, grad=True)
        out, mask = fn(ti, tc)
        torch.autograd.backward([out, mask], [torch.from_numpy(dout),
                                              torch.from_numpy(dmask)])
        grads.append((ti.grad.numpy(), tc.grad.numpy()))
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got, ref, **TOL_VJP)


def test_integer_coordinates_take_the_inside_branch():
    """At an exact integer x the x0 tap has weight 1 and the x1 tap weight 0; floor has
    zero gradient, so d out / dx = im(x0 + 1) - im(x0), as in both frameworks' autodiff."""
    imgs = np.arange(12, dtype=np.float32).reshape(1, 3, 4, 1) ** 2
    coords = np.array([[[[1.0, 1.0]]]], np.float32)
    ti, tc = _torch(imgs, coords, grad=True)
    out, mask = bs.bilinear_sample(ti, tc)
    out.sum().backward()
    assert out.item() == imgs[0, 1, 1, 0] and mask.item() == 1.0
    np.testing.assert_array_equal(tc.grad.numpy()[0, 0, 0],
                                  [imgs[0, 1, 2, 0] - imgs[0, 1, 1, 0],
                                   imgs[0, 2, 1, 0] - imgs[0, 1, 1, 0]])


def test_image_gradient_only_when_asked():
    imgs, coords = _case("jitter")
    ti, tc = _torch(imgs, coords)
    tc.requires_grad_(True)
    out, _ = bs.bilinear_sample(ti, tc)
    out.sum().backward()
    assert ti.grad is None and tc.grad is not None


def test_routing_by_sampler_name():
    imgs, coords = _torch(*_case("jitter"))
    before = bs.bilinear_sample.launches
    for sampler in ("xla", "pallas"):
        out, mask = routed_sample(imgs, coords, sampler=sampler)
        ref_out, ref_mask = bs.bilinear_sample_reference(imgs, coords)
        assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
    assert bs.bilinear_sample.launches == before
    with pytest.raises(ValueError):
        routed_sample(imgs, coords, sampler="grid_sample")


def _bad_inputs():
    imgs, coords = _torch(*_case("jitter"))
    return {
        "imgs_f64": (imgs.double(), coords),
        "coords_bf16": (imgs, coords.to(torch.bfloat16)),
        "coords_shape": (imgs, coords[..., :1]),
        "batch": (imgs[:1], coords),
        "non_contiguous": (imgs.transpose(1, 2), coords),
        "empty_image": (imgs[:, :0], coords),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        bs.bilinear_sample(*_bad_inputs()[case])


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config4_case(B=10, H=224, W=480, seed=0):
    """Images in [0, 255] and coords of a real depth warp at config 4's scale 0."""
    from tf_depth_estimation_torch.geometry.camera import (
        cam_to_pixel, matmul_f32, pad_intrinsics_4x4, pixel_to_cam)

    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy((rng.rand(B, H, W, 3) * 255).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    K = torch.tensor([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]]).expand(B, 3, 3)
    pose = torch.eye(4).repeat(B, 1, 1)
    pose[:, :3, 3] = torch.from_numpy(rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32))
    coords, _ = cam_to_pixel(pixel_to_cam(depth, K), matmul_f32(pad_intrinsics_4x4(K), pose))
    return imgs, coords.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ["config4"])
def test_cuda_kernel_forward_matches_plain(name):
    dev = _cuda()
    imgs, coords = _config4_case() if name == "config4" else _torch(*_case(name))
    imgs, coords = imgs.to(dev), coords.to(dev)
    before = bs.bilinear_sample.launches
    out, mask = bs.bilinear_sample(imgs, coords)
    torch.cuda.synchronize()
    assert bs.bilinear_sample.launches == before + 1
    ref_out, ref_mask = bs.bilinear_sample_reference(imgs, coords)
    # each product and sum rounded in the reference's order: exact on the card
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jitter", "wild", "integer", "odd_size", "config4"])
def test_cuda_kernel_vjp_matches_autograd_of_plain(name):
    dev = _cuda()
    imgs, coords = _config4_case(B=2) if name == "config4" else _torch(*_case(name))
    dout, dmask = _cotangents(imgs.numpy(), coords.numpy())
    grads = []
    for fn in (bs.bilinear_sample, bs.bilinear_sample_reference):
        ti = imgs.to(dev).requires_grad_(True)
        tc = coords.to(dev).requires_grad_(True)
        out, mask = fn(ti, tc)
        torch.autograd.backward([out, mask], [torch.from_numpy(dout).to(dev),
                                              torch.from_numpy(dmask).to(dev)])
        grads.append((ti.grad, tc.grad))
    scale = imgs.abs().max().item()   # 255 for config 4: the tolerance scales with it
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_dtypes():
    dev = _cuda()
    imgs, coords = _torch(*_case("jitter"))
    with pytest.raises(TypeError):
        bs.bilinear_sample(imgs.to(dev, torch.bfloat16), coords.to(dev))
