"""The tensor-core probes' plain versions (``ops/dot_loop.py``, ``ops/dot_grid.py``)
against the JAX probes (``tools/probe_int8_dot.py``, ``tools/probe_int8_dot2.py``) on the
CPU at small sizes: the probes' constants cut with ``monkeypatch`` (#6: M = K = N = 64,
R = 3; #7: 128 with 64x64 blocks) and ``pallas_call`` run in interpret mode. The ``cuda``
tests hold each kernel to its plain version on the card, as ``chip_smoke.py`` does.

JAX is imported inside the tests that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import functools

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.ops import dot_grid as dg
from tf_depth_estimation_torch.ops import dot_loop as dl
from tf_depth_estimation_torch.tools.common import inputs

LOOP = dict(M=64, K=64, N=64, R=3)
GRID = dict(M=128, K=128, N=128, BM=64, BN=64)
# bf16 operands: the JAX interpreter and PyTorch sum the same exact float32 products
# (bf16 x bf16 fits a float32 mantissa) in other orders, K = 64 or 128 terms of [0, 1)
TOL_CPU = 1e-6
# bf16 on the card, relative to max |plain|: the tensor cores add each 16-deep step of a
# product into the float32 sum with round-toward-zero alignment and normalisation (Fasi et
# al., "Numerical behavior of NVIDIA tensor cores", 2021), up to ~2 ulp a step, K / 16
# steps a product; twice that for the plain float32 product's own rounding. chip_smoke.py
# measured 3.7e-6 (K = 1024) and 1.6e-5 (K = 4096) on an NVIDIA H100 80GB HBM3 at 700 W.
def bf16_rtol(K):
    return 4 * (K // 16) * 2.0 ** -23


def _inputs(d):
    x = inputs(d["M"], d["K"], d["N"], device="cpu")
    return {"int8": (x["a8"], x["b8"]), "bf16": (x["abf"], x["bbf"])}


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pallas_call`` in interpret mode, so the TPU kernels run on the CPU."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def jax_loop(monkeypatch, interpret):
    import tools.probe_int8_dot as probe

    for k, v in LOOP.items():
        monkeypatch.setattr(probe, k, v)
    return probe


@pytest.fixture
def jax_grid(monkeypatch, interpret):
    import tools.probe_int8_dot2 as probe

    for k, v in GRID.items():
        monkeypatch.setattr(probe, k, v)
    return probe


def _jax_arrays(a, b):
    import jax.numpy as jnp

    if a.dtype == torch.int8:
        return jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    return (jnp.asarray(a.float().numpy(), jnp.bfloat16),
            jnp.asarray(b.float().numpy(), jnp.bfloat16))


def _close(got: np.ndarray, want: np.ndarray, dtype: str, tol: float = TOL_CPU):
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_loop_matches_the_jax_probe_scalar(jax_loop, dtype):
    """``make_pallas``'s scalar (the f32 sum of the R accumulated products) against the
    plain version's, and for int8 against the int64 numpy sum."""
    import jax.numpy as jnp

    a, b = _inputs(LOOP)[dtype]
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    got = float(jax_loop.make_pallas(a.dtype, acc)(*_jax_arrays(a, b)))
    plain = dl.dot_loop_reference(a, b, LOOP["R"])
    want = float(plain.float().sum())
    if dtype == "int8":
        exact = int((a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)).sum())
        assert got == want == np.float32(LOOP["R"] * exact)
    else:
        assert abs(got - want) <= TOL_CPU * abs(want)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_loop_matrix_matches_the_interpreted_tpu_kernel(jax_loop, dtype):
    """The whole [M, N] output of ``_dot_loop_kernel`` under an interpreted
    ``pallas_call`` against ``dot_loop`` on a CPU tensor (its plain version)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    a, b = _inputs(LOOP)[dtype]
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    M, N = LOOP["M"], LOOP["N"]
    out = pl.pallas_call(functools.partial(jax_loop._dot_loop_kernel, acc_dtype=acc),
                         out_shape=jax.ShapeDtypeStruct((M, N), acc))(*_jax_arrays(a, b))
    got = dl.dot_loop(a, b, LOOP["R"])
    assert got.dtype == (torch.int32 if dtype == "int8" else torch.float32)
    _close(got.numpy(), np.asarray(out), dtype)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_grid_matches_the_jax_probe(jax_grid, monkeypatch, dtype):
    """``make_pallas_grid`` on a (2, 2) grid of 64x64 tiles: its scalar, and its matrix
    (``jnp.sum`` made the identity while the probe traces) against ``dot_grid``."""
    import jax.numpy as jnp

    a, b = _inputs(GRID)[dtype]
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    got = dg.dot_grid(a, b)
    scalar = float(jax_grid.make_pallas_grid(acc)(*_jax_arrays(a, b)))
    want = float(got.float().sum())
    if dtype == "int8":
        assert scalar == want
    else:
        assert abs(scalar - want) <= TOL_CPU * abs(want)
    monkeypatch.setattr(jnp, "sum", lambda x: x)
    matrix = np.asarray(jax_grid.make_pallas_grid(acc)(*_jax_arrays(a, b)))
    _close(got.float().numpy(), matrix, dtype)


def test_the_plain_versions_are_exact_for_int8():
    """int8: float64 products and sums are exact integers, so the plain versions equal
    the int64 product (and R times it)."""
    a, b = _inputs(GRID)["int8"]
    exact = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    np.testing.assert_array_equal(dg.dot_grid_reference(a, b).numpy(), exact)
    loop = dl.dot_loop_reference(a[:64, :64].contiguous(), b[:64, :64].contiguous(), 5)
    np.testing.assert_array_equal(loop.numpy(), 5 * (a.numpy()[:64, :64].astype(np.int64)
                                                     @ b.numpy()[:64, :64]))


def test_the_bf16_loop_adds_the_products_in_turn():
    """bf16: R float32 products of the upcast values added in turn to a zero sum."""
    a, b = _inputs(LOOP)["bf16"]
    p = a.float() @ b.float()
    want = ((p + p) + p)
    assert torch.equal(dl.dot_loop_reference(a, b, 3), want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("fn, tile", [(dl.dot_loop, dl.TILE), (dg.dot_grid, dg.TILE)],
                         ids=["loop", "grid"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, tile, dtype):
    """The tile is the same for both types: TMA reads zeros past K in the last 128-byte
    stage, so K need not fill one."""
    M, N, K = tile[0], tile[1], tile[2]
    ones = functools.partial(torch.ones, dtype=dtype)
    a, b = ones((M, K)), ones((K, N))
    with pytest.raises(ValueError, match="multiple"):
        fn(ones((M + 8, K)), b)
    with pytest.raises(ValueError, match="multiple"):
        fn(a, ones((K, N + 8)))
    with pytest.raises(ValueError, match="multiple"):
        fn(ones((M, K + 8)), ones((K + 8, N)))
    other = torch.bfloat16 if dtype == torch.int8 else torch.int8
    with pytest.raises(TypeError):
        fn(a, b.to(other))
    with pytest.raises(TypeError):
        fn(a.float(), b.float())
    with pytest.raises(ValueError, match="contiguous"):
        fn(ones((K, M)).t(), b)
    with pytest.raises(ValueError):
        fn(a, ones((K + 64, N)))


def test_loop_refuses_sums_past_int32():
    a = torch.ones((64, 1024), dtype=torch.int8)
    b = torch.ones((1024, 64), dtype=torch.int8)
    assert dl.dot_loop(a, b, 64).dtype == torch.int32     # the probe's R and K: 1.07e9
    with pytest.raises(ValueError, match="int32"):
        dl.dot_loop(a, b, 128)
    with pytest.raises(ValueError, match="repeats"):
        dl.dot_loop(a, b, 0)


@pytest.mark.parametrize("mangled, label", [
    ("_ZN8dot_tile44_GLOBAL__N__c71bcff2_11_dot_grid_cu_c3a0eb7f10dot_kernelI13__nv_"
     "bfloat16Li256ELb0EEEv14CUtensorMap_stS2_S2_NS_6ParamsE",
     "dot_kernel<bf16, BN=256, grid>"),
    ("_ZN8dot_tile44_GLOBAL__N__2a6fbf25_11_dot_loop_cu_b93a203810dot_kernelIaLi128ELb1EEEv"
     "14CUtensorMap_stS1_S1_NS_6ParamsE", "dot_kernel<int8, BN=128, loop>"),
    ("_ZN8dot_tile44_GLOBAL__N__c71bcff2_11_dot_grid_cu_c3a0eb7f16transpose_kernelIhEEvPKT_"
     "PS2_ii", "transpose_kernel<h>"),
], ids=["grid_bf16", "loop_int8", "transpose"])
def test_the_smoke_names_the_probe_kernels_in_their_sass(mangled, label):
    """``chip_smoke.py`` reads each kernel's type from its mangled name in ``cuobjdump``'s
    listing, to check that bf16 products run on HGMMA and int8 ones on IGMMA."""
    import chip_smoke

    assert chip_smoke._kernel_label(mangled) == label


def _counts():
    return (dl.dot_loop.launches, dl.dot_loop.transposes, dl.dot_loop.reduces,
            dg.dot_grid.launches, dg.dot_grid.transposes)


def test_cpu_calls_launch_nothing():
    before = _counts()
    x = _inputs(GRID)["int8"]
    dg.dot_grid(*x)
    dl.dot_loop(x[0][:64, :64].contiguous(), x[1][:64, :64].contiguous(), 2)
    assert _counts() == before


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# name -> (wrapper, plain version, (M, K, N), extra args): the probes' shapes, small and
# rectangular ones, and for dot_grid 13 x 11 = 143 tiles of 128x256, one more wave than
# the 132 SMs take, the last one ragged
CUDA_CASES = {"loop": (dl.dot_loop, dl.dot_loop_reference, (1024, 1024, 1024), (64,)),
              "loop_small": (dl.dot_loop, dl.dot_loop_reference, (64, 192, 128), (3,)),
              "loop_rect": (dl.dot_loop, dl.dot_loop_reference, (192, 320, 448), (3,)),
              "grid": (dg.dot_grid, dg.dot_grid_reference, (4096, 4096, 4096), ()),
              "grid_oblong": (dg.dot_grid, dg.dot_grid_reference, (256, 384, 640), ()),
              "grid_rect": (dg.dot_grid, dg.dot_grid_reference, (384, 576, 1280), ()),
              "grid_ragged_wave": (dg.dot_grid, dg.dot_grid_reference, (1664, 512, 2816),
                                   ())}


def _hold_to_plain(fn, ref, a, b, extra):
    """One call of the kernel against the plain version: int8 bit-equal, bf16 within
    ``bf16_rtol(K)`` of max |plain|; one product launch, and one transpose of B for int8."""
    before = (fn.launches, fn.transposes)
    got = fn(a, b, *extra)
    torch.cuda.synchronize()
    assert (fn.launches, fn.transposes) == (before[0] + 1,
                                            before[1] + int(a.dtype == torch.int8))
    want = ref(a, b, *extra)
    if a.dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= bf16_rtol(a.shape[1]) * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(case, dtype):
    dev = _cuda()
    fn, ref, (M, K, N), extra = CUDA_CASES[case]
    a, b = _inputs(dict(M=M, K=K, N=N))[dtype]
    _hold_to_plain(fn, ref, a.to(dev), b.to(dev), extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("stages", [1, 13, 45])
@pytest.mark.parametrize("name", ["loop", "grid"])
def test_cuda_k_of_one_stage_to_many_turns_of_the_ring(name, stages, dtype):
    """K of 1, 13 and 45 stages of 128 bytes against a 4-stage ring: one stage; 13 (the
    grid wraps the ring three times, the loop splits K into 4 parts kept in shared
    memory); 45 (the loop's 8 parts stream through the ring each product)."""
    dev = _cuda()
    K = stages * 128 // (1 if dtype == "int8" else 2)
    a, b = _inputs(dict(M=256, K=K, N=256))[dtype]
    fn, ref = (dl.dot_loop, dl.dot_loop_reference) if name == "loop" else (
        dg.dot_grid, dg.dot_grid_reference)
    _hold_to_plain(fn, ref, a.to(dev), b.to(dev), (2,) if name == "loop" else ())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("repeats", [1, 2, 64])
def test_cuda_loop_repeats(repeats, dtype):
    dev = _cuda()
    a, b = _inputs(dict(M=256, K=512, N=384))[dtype]
    _hold_to_plain(dl.dot_loop, dl.dot_loop_reference, a.to(dev), b.to(dev), (repeats,))


@pytest.mark.cuda
@pytest.mark.parametrize("repeats, K", [(89, 1472), (23, 5696)])
def test_cuda_loop_int8_at_the_largest_sum_admitted(repeats, K):
    """int8 operands of +-127 at the largest R x K (a multiple of 64) that the wrapper
    admits, 2047 x 64: out[0, 0] and out[0, 1] are +-R K 127^2 = +-2,113,028,032, next to
    the int32 limit, and the whole output is bit-equal."""
    dev = _cuda()
    rng = np.random.RandomState(1)
    a = rng.choice(np.array([-127, 127], dtype=np.int8), (128, K))
    b = rng.choice(np.array([-127, 127], dtype=np.int8), (K, 128))
    a[0], b[:, 0], b[:, 1] = 127, 127, -127
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = dl.dot_loop(a, b, repeats)
    assert got[0, 0].item() == repeats * K * 127 ** 2 == -got[0, 1].item()
    _hold_to_plain(dl.dot_loop, dl.dot_loop_reference, a, b, (repeats,))
    with pytest.raises(ValueError, match="int32"):
        dl.dot_loop(a, b, repeats + 1)


@pytest.mark.cuda
def test_cuda_loop_sums_its_k_parts_once():
    """At the probe's K = 1024 the loop splits K into 2 (int8) or 4 (bf16) parts and adds
    them in one more launch, counted in ``dot_loop.reduces``; K of one stage needs none."""
    dev = _cuda()
    for K, want in ((1024, 1), (64, 0)):
        for dtype in ("int8", "bf16"):
            a, b = _inputs(dict(M=128, K=K, N=128))[dtype]
            before = dl.dot_loop.reduces
            dl.dot_loop(a.to(dev), b.to(dev), 2)
            assert dl.dot_loop.reduces - before == want, (K, dtype)


@pytest.mark.cuda
def test_cuda_kernels_refuse_a_shape_off_the_tile():
    dev = _cuda()
    a = torch.ones((1000, 1024), dtype=torch.int8, device=dev)
    b = torch.ones((1024, 1024), dtype=torch.int8, device=dev)
    before = _counts()
    for fn in (dl.dot_loop, dg.dot_grid):
        with pytest.raises(ValueError, match="multiple"):
            fn(a, b)
    assert _counts() == before
