"""Port ops (TF1-legacy resizes, pixel packing) against the JAX functions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.ops import phase as jphase
from tf_depth_estimation_tpu.ops import resize as jresize
from tf_depth_estimation_torch.ops import phase, resize

TOL = dict(rtol=1e-6, atol=1e-6)  # f32; same weights, sums of at most 4 taps


def _img(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(fn, x_nhwc, *args):
    """Run a port resize (NCHW) on an NHWC numpy array, return NHWC numpy."""
    y = fn(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2), *args)
    return y.permute(0, 2, 3, 1).numpy()


BILINEAR = [((5, 7), (10, 14)), ((6, 8), (12, 16)), ((5, 7), (9, 13)),
            ((12, 16), (5, 7)), ((9, 13), (9, 13)), ((8, 12), (32, 48))]


@pytest.mark.parametrize("src,dst", BILINEAR)
def test_resize_bilinear_matches_jax(src, dst):
    x = _img((2, *src, 3))
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst))
    np.testing.assert_allclose(_port(resize.resize_bilinear, x, dst), ref, **TOL)


NEAREST = [((5, 9), (10, 18)), ((10, 18), (9, 17)), ((5, 5), (9, 9)), ((7, 3), (7, 3)),
           ((4, 6), (3, 5))]


@pytest.mark.parametrize("src,dst", NEAREST)
def test_resize_nearest_matches_jax(src, dst):
    x = _img((2, *src, 4))
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(_port(resize.resize_nearest, x, dst), ref)


@pytest.mark.parametrize("src,ref_hw", [((10, 10), (9, 9)), ((6, 10), (5, 9)),
                                        ((9, 9), (9, 9))])
def test_resize_like_matches_jax(src, ref_hw):
    """The 576-wide encoder runs 9 -> 5 at cnv7, so upcnv7 gives 10 where cnv6b has 9."""
    x = _img((1, *src, 3))
    r = _img((1, *ref_hw, 2), seed=1)
    want = np.asarray(jresize.resize_like(jnp.asarray(x), jnp.asarray(r)))
    got = resize.resize_like(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(r).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_resize_bilinear_is_not_half_pixel():
    """TF1 legacy (src = dst * in/out) differs from F.interpolate's half-pixel centres."""
    x = torch.from_numpy(_img((1, 1, 5, 7)))
    ours = resize.resize_bilinear(x, (9, 13))
    theirs = torch.nn.functional.interpolate(x, (9, 13), mode="bilinear",
                                             align_corners=False)
    assert not torch.allclose(ours, theirs, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (1, 8, 2, 16)])
def test_space_to_depth_and_back(shape):
    x = _img(shape)
    packed = phase.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jphase.space_to_depth(x)))
    np.testing.assert_array_equal(phase.depth_to_space(packed).numpy(), x)
    y = _img((shape[0], shape[1] // 2, shape[2] // 2, 4 * shape[3]), seed=2)
    np.testing.assert_array_equal(phase.depth_to_space(torch.from_numpy(y)).numpy(),
                                  np.asarray(jphase.depth_to_space(y)))


AREA = [((8, 12), (4, 6)), ((8, 12), (2, 3)), ((9, 13), (4, 5)), ((7, 5), (3, 2)),
        ((6, 10), (6, 10)), ((5, 7), (8, 9))]


@pytest.mark.parametrize("src,dst", AREA)
def test_resize_area_matches_jax(src, dst):
    """Integer factors take the average pool, other ratios the TF1 area weights."""
    x = _img((2, *src, 3), seed=3)
    ref = np.asarray(jresize.resize_area(jnp.asarray(x), dst))
    np.testing.assert_allclose(_port(resize.resize_area, x, dst), ref, **TOL)


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((5, 7), (9, 13)),
                                     ((12, 16), (5, 7))])
def test_resize_bilinear_gradient_matches_jax(src, dst):
    """The decoder differentiates its disparity upsamples: the gradient of <resize(x), g>
    against jax.grad, on the x2 stencil and on the weight-matrix path."""
    import jax

    x, g = _img((2, *src, 3), seed=4), _img((2, *dst, 3), seed=5)
    ref = jax.grad(lambda a: jnp.sum(jresize.resize_bilinear(a, dst) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (resize.resize_bilinear(xt, dst) * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
