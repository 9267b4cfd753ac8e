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


@pytest.mark.parametrize("fn, tile", [(dl.dot_loop, dl.TILE), (dg.dot_grid, dg.TILE)],
                         ids=["loop", "grid"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, tile):
    M, N, K = tile[0], tile[1], tile[2]
    a8, b8 = torch.ones((M, K), dtype=torch.int8), torch.ones((K, N), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple"):
        fn(torch.ones((M + 8, K), dtype=torch.int8), b8)
    with pytest.raises(ValueError, match="multiple"):
        fn(torch.ones((M, K + 8), dtype=torch.int8), torch.ones((K + 8, N),
                                                                  dtype=torch.int8))
    with pytest.raises(TypeError):
        fn(a8, b8.to(torch.bfloat16))
    with pytest.raises(TypeError):
        fn(a8.float(), b8.float())
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.ones((K, M), dtype=torch.int8).t(), b8)
    with pytest.raises(ValueError):
        fn(a8, torch.ones((K + 64, N), dtype=torch.int8))


def test_loop_refuses_sums_past_int32():
    a = torch.ones((64, 1024), dtype=torch.int8)
    b = torch.ones((1024, 64), dtype=torch.int8)
    assert dl.dot_loop(a, b, 64).dtype == torch.int32     # the probe's R and K: 1.07e9
    with pytest.raises(ValueError, match="int32"):
        dl.dot_loop(a, b, 128)
    with pytest.raises(ValueError, match="repeats"):
        dl.dot_loop(a, b, 0)


def test_cpu_calls_launch_nothing():
    before = (dl.dot_loop.launches, dg.dot_grid.launches)
    x = _inputs(GRID)["int8"]
    dg.dot_grid(*x)
    dl.dot_loop(x[0][:64, :64].contiguous(), x[1][:64, :64].contiguous(), 2)
    assert (dl.dot_loop.launches, dg.dot_grid.launches) == before


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_CASES = {"loop": (dl.dot_loop, dl.dot_loop_reference, (1024, 1024, 1024), (64,)),
              "loop_small": (dl.dot_loop, dl.dot_loop_reference, (64, 192, 128), (3,)),
              "grid": (dg.dot_grid, dg.dot_grid_reference, (4096, 4096, 4096), ()),
              "grid_oblong": (dg.dot_grid, dg.dot_grid_reference, (256, 384, 640), ())}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(case, dtype):
    """int8 bit-equal, bf16 within ``bf16_rtol``, one launch a call."""
    dev = _cuda()
    fn, ref, (M, K, N), extra = CUDA_CASES[case]
    a, b = _inputs(dict(M=M, K=K, N=N))[dtype]
    a, b = a.to(dev), b.to(dev)
    before = fn.launches
    got = fn(a, b, *extra)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(a, b, *extra)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= bf16_rtol(K) * want.abs().max().item(), err


@pytest.mark.cuda
def test_cuda_kernels_refuse_a_shape_off_the_tile():
    dev = _cuda()
    a = torch.ones((1000, 1024), dtype=torch.int8, device=dev)
    b = torch.ones((1024, 1024), dtype=torch.int8, device=dev)
    before = (dl.dot_loop.launches, dg.dot_grid.launches)
    for fn in (dl.dot_loop, dg.dot_grid):
        with pytest.raises(ValueError, match="multiple"):
            fn(a, b)
    assert (dl.dot_loop.launches, dg.dot_grid.launches) == before
