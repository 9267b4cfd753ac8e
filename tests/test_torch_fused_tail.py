"""The port's fused decoder tail against the JAX tail (its reference graph and the Pallas
kernel in interpret mode), and the CUDA kernel against the port's reference.

JAX is imported inside the tests that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf_depth_estimation_torch.ops import fused_tail as ft

TOL_F32 = dict(rtol=2e-5, atol=2e-5)   # tests/test_pallas_tail.py
# bf16: intermediates are rounded to bf16 at the concat and before disp1; where the two
# f32 sums differ in their last bits, a value can round to the neighbouring bf16 number
# (1/256 relative) and move d1 by up to ~1e-3. Nearly every output agrees far closer.
TOL_BF16_MAX, TOL_BF16_MEAN = 1e-2, 1e-4


def _case(H, W, seed=0, batch=2):
    """Inputs as tests/test_pallas_tail.py makes them (numpy, JAX layouts)."""
    rng = np.random.RandomState(seed)
    return dict(
        x2=rng.randn(batch, H, W, 32).astype(np.float32) * 0.5,
        d2=rng.rand(batch, H, W, 1).astype(np.float32) * 4.0,
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
    assert p["packed"].numel() == ft.N_PARAMS == (9 * 32 * 16 + 9 * 17 * 16 + 9 * 16 + 65
                                                  + 64 * 128 + 16 * 160)
    assert p["w_ic"].data_ptr() == p["packed"].data_ptr() + 4 * 9 * 32 * 16
    assert p["k_ic"].data_ptr() + 4 * 16 * 160 == p["packed"].data_ptr() + 4 * ft.N_PARAMS


def test_params_keep_disp1_in_host_memory():
    """The bf16 kernel takes disp1's f32 weights and bias as launch arguments, from host
    memory, whatever device the packed buffer is on."""
    p = _port_params(_case(4, 4), torch.bfloat16)
    head = p["disp1_host"]
    assert head.device.type == "cpu" and head.dtype == torch.float32
    assert torch.equal(head, torch.cat([p["w_d1"].reshape(-1), p["b_d1"]]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_upcnv1_operand_is_jax_k_up_transposed(dtype):
    """The bf16 kernel's upcnv1 operand, rows (p, q, o) and columns (cy, cx, ci), is the
    transpose of the phase GEMM matrix JAX builds (``pallas_tail.py:61-64``), whose rows
    are (cy, cx, ci) and columns (p, q, o)."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_tail import prepare_tail_params as jprepare

    c = _case(4, 4)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda a: jnp.asarray(a)
    k_up = jprepare(j(c["w_up1"]), tuple(map(j, c["bn_up"])), j(c["w_ic"]),
                    tuple(map(j, c["bn_ic"])), j(c["w_d1"]), jnp.float32(c["b_d1"]),
                    jdt)["K_up"]
    got = _port_params(c, dtype)["k_up"]
    assert got.shape == (64, 128)
    np.testing.assert_array_equal(got.t().numpy(), np.asarray(k_up, np.float32))


def _gemm_emulation(x2, d2, p, disp_scaling=4.0, min_disp=0.0):
    """The bf16 kernel's arithmetic in plain PyTorch: upcnv1 as rows of 4 shifted x2 cells
    times ``k_up``, icnv1 as rows of 9 shifted cat pixels (16 up channels each), 9 d2u taps
    and 7 zeros times ``k_ic``, with the kernel's rounding points; disp1 as a conv."""
    from tf_depth_estimation_torch.models.layers import conv2d_same
    from tf_depth_estimation_torch.ops.resize import resize_bilinear

    rnd = (lambda t: t.to(x2.dtype).float()) if x2.dtype != torch.float32 else (lambda t: t)
    B, h, w, _ = x2.shape
    H, W = 2 * h, 2 * w
    xp = F.pad(x2.float(), (0, 0, 1, 1, 1, 1))      # x2 cell (U, V) at [U + 1, V + 1]
    rows = torch.cat([xp[:, cy:cy + h, cx:cx + w] for cy in (0, 1) for cx in (0, 1)], -1)
    phases = (rows @ p["k_up"].t()).view(B, h, w, 2, 2, 16)        # (p, q, o)
    up = phases.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, 16)
    up = rnd(torch.relu(up * p["su"] + p["tu"]))
    d2u = rnd(resize_bilinear(d2.permute(0, 3, 1, 2).float(), (H, W)).permute(0, 2, 3, 1))
    up_p, d2u_p = F.pad(up, (0, 0, 1, 1, 1, 1)), F.pad(d2u, (0, 0, 1, 1, 1, 1))
    taps = [(a, b) for a in range(3) for b in range(3)]
    rows = torch.cat([up_p[:, a:a + H, b:b + W] for a, b in taps]
                     + [d2u_p[:, a:a + H, b:b + W] for a, b in taps]
                     + [up.new_zeros(B, H, W, 7)], -1)
    assert rows.shape[-1] == 160
    y = rnd(torch.relu((rows @ p["k_ic"].t()) * p["si"] + p["ti"]))
    d1 = conv2d_same(y.permute(0, 3, 1, 2), p["w_d1"].permute(2, 0, 1)[None], p["b_d1"])
    return (disp_scaling * torch.sigmoid(d1) + min_disp).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(8, 16), (7, 11)])
def test_gemm_emulation_with_packed_operands_matches_reference(hw, dtype):
    """The GEMM formulation and the packed operands the bf16 kernel reads compute the
    tail: 16x32 and 14x22 outputs, B = 2."""
    c = _case(*hw)
    p = _port_params(c, dtype)
    x2 = torch.from_numpy(c["x2"]).to(dtype)
    d2 = torch.from_numpy(c["d2"])
    got = _gemm_emulation(x2, d2, p)
    ref = ft.fused_tail_reference(x2, d2, p)
    assert got.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], 1)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, **TOL_F32)
    else:
        err = (got - ref).abs()
        assert err.max() <= TOL_BF16_MAX and err.mean() <= TOL_BF16_MEAN, (err.max(),
                                                                           err.mean())


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


def _cuda_case(hw, batch, dtype=torch.bfloat16):
    """Seeded inputs and params on the card at ``batch`` frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    c = _case(*hw, batch=batch)
    return (torch.from_numpy(c["x2"]).cuda().to(dtype), torch.from_numpy(c["d2"]).cuda(),
            _port_params(c, dtype, "cuda"))


F32, BF16 = torch.float32, torch.bfloat16
# (13, 21): one strip, ragged inside its 64-cell block; (7, 125): 250 output columns in
# three strips of 84, the last one ragged; (192, 288): the serving shape, five strips.
# In the last four cases the bf16 kernel's persistent blocks (three a SM on 132 SMs) take
# several items each: about 1.9 at (16, 32) x 256, 1.5 at (7, 125) x 200, 2.8 at
# (192, 288) x 16 and 4.8 at x 64, so its walk across items (the next item's TMA loads,
# the mbarrier phases) is held to the reference too.
CUDA_CASES = ([(hw, 2, dt) for hw in [(16, 32), (13, 21), (192, 288)] for dt in (F32, BF16)]
              + [(hw, b, BF16) for hw in [(16, 32), (13, 21), (7, 125), (192, 288)]
                 for b in (1, 3)]
              + [((16, 32), 256, BF16), ((7, 125), 200, BF16), ((192, 288), 16, BF16),
                 ((192, 288), 64, BF16)])


@pytest.mark.cuda
@pytest.mark.parametrize("hw, batch, dtype", CUDA_CASES)
def test_cuda_kernel_matches_reference(hw, batch, dtype):
    x2, d2, p = _cuda_case(hw, batch, dtype)
    before = ft.fused_tail.launches
    got = ft.fused_tail(x2, d2, p)
    torch.cuda.synchronize()
    assert ft.fused_tail.launches == before + 1
    ref = ft.fused_tail_reference(x2, d2, p)
    err = (got - ref).abs()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert err.max().item() <= TOL_BF16_MAX and err.mean().item() <= TOL_BF16_MEAN, (
            err.max().item(), err.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 16])
def test_cuda_bf16_kernel_gives_the_same_bits_twice(batch):
    x2, d2, p = _cuda_case((192, 288), batch)
    first = ft.fused_tail(x2, d2, p)
    second = ft.fused_tail(x2, d2, p)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_bf16_kernel_refuses_a_misaligned_x2():
    x2, d2, p = _cuda_case((16, 32), 1)
    flat = torch.empty(x2.numel() + 8, dtype=torch.bfloat16, device="cuda")
    view = flat[1:1 + x2.numel()].view(x2.shape)   # 2 bytes past a 16-byte boundary
    view.copy_(x2)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    before = ft.fused_tail.launches
    with pytest.raises(ValueError, match="16-byte"):
        ft.fused_tail(view, d2, p)
    assert ft.fused_tail.launches == before


@pytest.mark.parametrize("mangled, label", [
    ("_ZN46_GLOBAL__N__0dcdf128_13_fused_tail_cu_a9404a842tc16tail_bf16_kernelE14CUtensorMap_"
     "stPKfS3_PfNS0_4PlanE", "tail_bf16_kernel"),
    ("_ZN46_GLOBAL__N__0dcdf128_13_fused_tail_cu_a9404a8417fused_tail_kernelEPKfS1_S1_Pfiiff",
     "fused_tail_kernel<f32>"),
], ids=["bf16", "f32"])
def test_the_smoke_names_the_tail_kernels_in_their_sass(mangled, label):
    import chip_smoke

    assert chip_smoke._kernel_label(mangled) == label


_SASS = dict(HGMMA=12, IGMMA=0, UTMALDG=1, UTMASTG=0, HMMA=0, IMMA=0)


@pytest.mark.parametrize("bf16, ok", [
    (_SASS, True),
    (dict(_SASS, HGMMA=0), False),
    (dict(_SASS, UTMALDG=0), False),
    (dict(_SASS, HMMA=4), False),
    (None, False),
], ids=["wgmma_tma", "no_hgmma", "no_utmaldg", "mma_sync", "no_kernel"])
def test_the_smoke_holds_the_bf16_tail_to_wgmma_fed_by_tma(bf16, ok):
    """``chip_smoke.py`` fails unless the bf16 tail kernel's SASS holds HGMMA and UTMALDG
    and no HMMA; the f32 kernel (CUDA cores, by design) is not held."""
    import chip_smoke

    counts = {"fused_tail_kernel<f32>": dict(_SASS, HGMMA=0, UTMALDG=0)}
    if bf16 is not None:
        counts["tail_bf16_kernel"] = bf16
    if ok:
        chip_smoke.hold_tail_sass(counts)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.hold_tail_sass(counts)


def test_every_tail_variant_patches_the_committed_source():
    """``tools/tail_variants.py`` builds patched copies of ``csrc/fused_tail.cu``; each
    patch's text must still be in the source, or the tool raises on the card."""
    import os

    from tf_depth_estimation_torch.ops import _build
    from tf_depth_estimation_torch.tools.tail_variants import VARIANTS

    for name, patches in VARIANTS.items():
        for f, old, _ in patches:
            with open(os.path.join(_build.CSRC, f)) as fh:
                assert old in fh.read(), (name, old)
