"""The port's fused decoder tail against the JAX tail (its reference graph and the Pallas
kernel in interpret mode), and the CUDA kernel against the port's reference.

JAX is imported inside the tests that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.ops import fused_tail as ft

TOL_F32 = dict(rtol=2e-5, atol=2e-5)   # tests/test_pallas_tail.py
# bf16: intermediates are rounded to bf16 at the concat and before disp1; where the two
# f32 sums differ in their last bits, a value can round to the neighbouring bf16 number
# (1/256 relative) and move d1 by up to ~1e-3. Nearly every output agrees far closer.
TOL_BF16_MAX, TOL_BF16_MEAN = 1e-2, 1e-4


def _case(H, W, seed=0):
    """Inputs as tests/test_pallas_tail.py makes them (numpy, JAX layouts)."""
    rng = np.random.RandomState(seed)
    return dict(
        x2=rng.randn(2, H, W, 32).astype(np.float32) * 0.5,
        d2=rng.rand(2, H, W, 1).astype(np.float32) * 4.0,
        w_up1=rng.randn(3, 3, 16, 32).astype(np.float32) * 0.1,
        w_ic=rng.randn(3, 3, 17, 16).astype(np.float32) * 0.1,
        w_d1=rng.randn(3, 3, 16, 1).astype(np.float32) * 0.1,
        b_d1=np.float32(0.13),
        bn_up=(rng.rand(16).astype(np.float32) + 0.5,
               rng.randn(16).astype(np.float32) * 0.1),
        bn_ic=(rng.rand(16).astype(np.float32) + 0.5,
               rng.randn(16).astype(np.float32) * 0.1))


def _port_params(c, dtype, device="cpu"):
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return ft.prepare_tail_params(
        t(c["w_up1"]).permute(3, 2, 0, 1), tuple(map(t, c["bn_up"])),
        t(c["w_ic"]).permute(3, 2, 0, 1), tuple(map(t, c["bn_ic"])),
        t(c["w_d1"]).permute(3, 2, 0, 1), t([c["b_d1"]]), dtype)


def _jax_kernel(c, dtype, tile_rows):
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_tail import fused_tail as jfused_tail
    from tf_depth_estimation_tpu.ops.pallas_tail import prepare_tail_params as jprepare
    from tf_depth_estimation_tpu.ops.phase import depth_to_space as jdepth_to_space

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda a: jnp.asarray(a)
    p = jprepare(j(c["w_up1"]), tuple(map(j, c["bn_up"])), j(c["w_ic"]),
                 tuple(map(j, c["bn_ic"])), j(c["w_d1"]), jnp.float32(c["b_d1"]), jdt)
    out = jfused_tail(j(c["x2"]).astype(jdt), j(c["d2"]), p, tile_rows=tile_rows,
                      interpret=True)
    return np.asarray(jdepth_to_space(out))


SHAPES = [((16, 32), 8), ((32, 48), 16)]   # tests/test_pallas_tail.py:33


@pytest.mark.parametrize("hw,tr", SHAPES)
def test_reference_matches_jax_reference_graph(hw, tr):
    import jax.numpy as jnp
    from test_pallas_tail import _reference_tail

    c = _case(*hw)
    j = lambda a: jnp.asarray(a)
    ref = _reference_tail(j(c["x2"]), j(c["d2"]), j(c["w_up1"]), tuple(map(j, c["bn_up"])),
                          j(c["w_ic"]), tuple(map(j, c["bn_ic"])), j(c["w_d1"]),
                          jnp.float32(c["b_d1"]))
    got = ft.fused_tail_reference(torch.from_numpy(c["x2"]), torch.from_numpy(c["d2"]),
                                  _port_params(c, torch.float32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_F32)


@pytest.mark.parametrize("hw,tr", SHAPES)
def test_wrapper_on_cpu_matches_jax_interpret_kernel_f32(hw, tr):
    c = _case(*hw)
    before = ft.fused_tail.launches
    got = ft.fused_tail(torch.from_numpy(c["x2"]), torch.from_numpy(c["d2"]),
                        _port_params(c, torch.float32))
    assert ft.fused_tail.launches == before        # only kernel launches count
    np.testing.assert_allclose(got.numpy(), _jax_kernel(c, torch.float32, tr), **TOL_F32)


@pytest.mark.parametrize("hw,tr", SHAPES)
def test_reference_matches_jax_interpret_kernel_bf16(hw, tr):
    c = _case(*hw)
    got = ft.fused_tail(torch.from_numpy(c["x2"]).to(torch.bfloat16),
                        torch.from_numpy(c["d2"]), _port_params(c, torch.bfloat16)).numpy()
    err = np.abs(got - _jax_kernel(c, torch.bfloat16, tr))
    assert err.max() <= TOL_BF16_MAX and err.mean() <= TOL_BF16_MEAN, (err.max(),
                                                                       err.mean())


def test_disp_scaling_and_min_disp():
    c = _case(8, 8)
    args = (torch.from_numpy(c["x2"]), torch.from_numpy(c["d2"]),
            _port_params(c, torch.float32))
    base = ft.fused_tail(*args)
    scaled = ft.fused_tail(*args, disp_scaling=10.0, min_disp=0.001)
    np.testing.assert_allclose(scaled.numpy(), (base.numpy() / 4.0) * 10.0 + 0.001,
                               rtol=1e-5, atol=1e-5)


def test_params_pack_into_one_buffer():
    p = _port_params(_case(4, 4), torch.float32)
    assert p["packed"].numel() == ft.N_PARAMS == 9 * 32 * 16 + 9 * 17 * 16 + 9 * 16 + 65
    assert p["w_ic"].data_ptr() == p["packed"].data_ptr() + 4 * 9 * 32 * 16


def _bad_inputs():
    c = _case(4, 6)
    x2, d2 = torch.from_numpy(c["x2"]), torch.from_numpy(c["d2"])
    p = _port_params(c, torch.float32)
    short = dict(p, packed=p["packed"][:-1])
    return {
        "channels": (x2[..., :16], d2, p),
        "dtype": (x2.half(), d2, p),
        "d2_shape": (x2, d2[:, :-1], p),
        "d2_dtype": (x2, d2.double(), p),
        "non_contiguous": (x2.transpose(1, 2), d2.transpose(1, 2), p),
        "params": (x2, d2, short),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        ft.fused_tail(*_bad_inputs()[case])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(16, 32), (13, 21), (192, 288)])
def test_cuda_kernel_matches_reference(hw, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    c = _case(*hw)
    p = _port_params(c, dtype, "cuda")
    x2 = torch.from_numpy(c["x2"]).cuda().to(dtype)
    d2 = torch.from_numpy(c["d2"]).cuda()
    before = ft.fused_tail.launches
    got = ft.fused_tail(x2, d2, p)
    torch.cuda.synchronize()
    assert ft.fused_tail.launches == before + 1
    ref = ft.fused_tail_reference(x2, d2, p)
    err = (got - ref).abs()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert err.max().item() <= TOL_BF16_MAX and err.mean().item() <= TOL_BF16_MEAN
