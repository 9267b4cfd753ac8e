"""The sig kernel pair and the small ops of split_training against the JAX package.

``sig_l2_fused`` on the CPU (the plain composition) against JAX's ``sig_l2_fused`` (the
Pallas kernel in interpret mode) and ``_sig_jnp_ref``, in value and gradient; the
backward's gather formula against autograd; the C=2 fallback, a map the deltas overreach
and a strided plane; ``replace_nonfinite`` and the schedules. The ``cuda`` tests hold the
CUDA kernels to the plain version on the card.

JAX is imported inside the tests and fixtures that use it: the GPU machine has no JAX,
and runs the ``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.ops import schedules
from tf_depth_estimation_torch.ops.nonfinite import replace_nonfinite
from tf_depth_estimation_torch.ops.sig import sig_l2_plain
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_backward_reference, sig_l2_fused

# the limits of tests/test_pallas.py:56,66 for the sig kernel: value rtol 1e-5, gradient
# atol 1e-6 (the gradient's entries are 1e-5 to 1e-3 here)
TOL_VALUE = dict(rtol=1e-5)
TOL_GRAD = dict(rtol=0, atol=1e-6)
FIVE = (1, 2, 4, 8, 16)


def _sig_case(name, seed=0):
    """(base, view, gt, deltas), float32 CPU tensors; ``view(base)`` is the prediction.
    "strided" is channel 1 of an NCHW [B, 2, H, W] head viewed NHWC, as the heads reach
    the loss; "coarse" is a map that the deltas 8 and 16 overreach in y and 16 in x."""
    rng = np.random.RandomState(seed)
    u = lambda *shape: torch.from_numpy(rng.uniform(0.5, 2, shape).astype(np.float32))
    same = lambda t: t
    if name == "strided":
        return u(2, 2, 24, 32), lambda t: t.permute(0, 2, 3, 1)[..., 1:2], \
            u(2, 24, 32, 1), (2,)
    shapes = {"delta2": ((2, 24, 32, 1), (2,)), "five": ((2, 24, 32, 1), FIVE),
              "odd": ((2, 37, 53, 1), FIVE), "coarse": ((2, 6, 16, 1), FIVE),
              "c2": ((2, 12, 16, 2), (2,))}
    shape, deltas = shapes[name]
    return u(*shape), same, u(*shape), deltas


CASES = ["delta2", "five", "odd", "coarse", "strided"]


def _grads(fn, base, view, gt, deltas):
    """(fn(view(base), gt), d/d view(base), d/d gt) through autograd."""
    base = base.detach().clone().requires_grad_(True)
    gt = gt.detach().clone().requires_grad_(True)
    out = fn(view(base), gt, deltas)
    db, dg = torch.autograd.grad(out, [base, gt])
    return out.detach(), view(db), dg


@pytest.mark.parametrize("name", CASES + ["c2"])
def test_sig_l2_fused_matches_jax_kernel_and_reference(name):
    """The port's wrapper on the CPU against JAX's ``sig_l2_fused`` in interpret mode
    (the Pallas kernel; for C=2 its plain fallback) and ``_sig_jnp_ref``, value and
    gradient for pred and gt."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_losses import _sig_jnp_ref
    from tf_depth_estimation_tpu.ops.pallas_losses import sig_l2_fused as jsig

    base, view, gt, deltas = _sig_case(name)
    got, dp, dg = _grads(sig_l2_fused, base, view, gt, deltas)
    p, g = jnp.asarray(view(base).numpy()), jnp.asarray(gt.numpy())
    kernel = jax.jit(jax.value_and_grad(
        lambda a, b: jsig(a, b, deltas, 0.001, 1e-6, True), argnums=(0, 1)))
    plain = jax.jit(jax.value_and_grad(lambda a, b: _sig_jnp_ref(a, b, deltas, 0.001, 1e-6),
                                       argnums=(0, 1)))
    for value, (gp, gg) in (kernel(p, g), plain(p, g)):
        np.testing.assert_allclose(got.item(), float(value), **TOL_VALUE)
        np.testing.assert_allclose(dp.numpy(), np.asarray(gp), **TOL_GRAD)
        np.testing.assert_allclose(dg.numpy(), np.asarray(gg), **TOL_GRAD)


@pytest.mark.parametrize("name", CASES)
def test_backward_gather_formula_matches_autograd(name):
    """The same terms as autograd of the plain composition, rounded in another order:
    within a few float32 ulp of max|g|; a cotangent of 3 triples the gradient."""
    base, view, gt, deltas = _sig_case(name)
    _, dp, dg = _grads(sig_l2_plain, base, view, gt, deltas)
    rp, rg = sig_l2_backward_reference(view(base), gt, torch.tensor(1.0), deltas)
    rp3, rg3 = sig_l2_backward_reference(view(base), gt, torch.tensor(3.0), deltas)
    for got, ref in ((rp, dp), (rg, dg), (rp3, 3 * dp), (rg3, 3 * dg)):
        tol = 1e-6 * ref.abs().max().item()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)


def test_wrapper_refuses_what_it_does_not_take():
    base, _, gt, _ = _sig_case("delta2")
    with pytest.raises(TypeError):
        sig_l2_fused(base.to(torch.bfloat16), gt)
    with pytest.raises(ValueError):
        sig_l2_fused(base, gt[:, :-1])
    for deltas in ((), (0,), tuple(range(1, 10))):
        with pytest.raises(ValueError):
            sig_l2_fused(base, gt, deltas)


def test_replace_nonfinite_matches_jax_in_value_and_gradient():
    """NaN and Inf entries become the value and get no gradient, even from a NaN
    cotangent at their sites."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.nonfinite import replace_nonfinite as jreplace

    x = np.array([1.5, np.nan, -2.0, np.inf, -np.inf, 0.0], np.float32)
    ct = np.array([1.0, np.nan, 2.0, 3.0, np.nan, -1.0], np.float32)
    for value in (0.0, 7.0):
        t = torch.from_numpy(x.copy()).requires_grad_(True)
        out = replace_nonfinite(t, value)
        out.backward(torch.from_numpy(ct))
        ref, vjp = jax.vjp(lambda a: jreplace(a, value), jnp.asarray(x))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))
    np.testing.assert_array_equal(t.grad.numpy(), [1, 0, 2, 0, 0, -1])


def test_schedules_match_jax():
    """The sig weight's ease-out and phase 1's staircase decay, float32 for float32."""
    from tf_depth_estimation_tpu.ops import schedules as jschedules

    jdecay = jschedules.exponential_decay(2e-4, 10000, 0.96)
    decay = schedules.exponential_decay(2e-4, 10000, 0.96)
    smooth = schedules.exponential_decay(2e-4, 10000, 0.96, staircase=False)
    for t in (0, 1, 7, 9999, 10000, 19999, 66666, 199999, 200000, 600000):
        assert schedules.ease_out_quad(t, 0.0, 1000.0, 200000.0) == float(
            jschedules.ease_out_quad(t, 0.0, 1000.0, 200000.0))
        assert decay(t) == float(jdecay(t))
        assert smooth(t) == float(jschedules.exponential_decay(2e-4, 10000, 0.96, False)(t))
    assert decay(19999) == decay(10000) < decay(9999)


def test_sig_ramp_is_nan_below_three_max_steps_in_both_packages():
    """A run of fewer than 3 steps ramps the sig weight over max_steps // 3 = 0 steps: the
    weight at step 0 is 0/0, NaN in the JAX package, and in the port, which keeps its
    arithmetic (ROADMAP Queue 3)."""
    from tf_depth_estimation_tpu.ops import schedules as jschedules

    with np.errstate(divide="ignore", invalid="ignore"):
        assert np.isnan(schedules.ease_out_quad(0, 0.0, 1000.0, float(2 // 3)))
    assert np.isnan(float(jschedules.ease_out_quad(0, 0.0, 1000.0, float(2 // 3))))


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernels_match_plain_version(name):
    """Forward within rtol 1e-5 of the plain composition (float32 and float64), one launch
    each way, the same bits in two runs, and the backward within 1e-6 of autograd and
    equal to the gather formula."""
    dev = _cuda()
    base, view, gt, deltas = _sig_case(name)
    base, gt = base.to(dev), gt.to(dev)
    before = (sig_l2_fused.launches, sig_l2_fused.backward_launches)
    got, dp, dg = _grads(sig_l2_fused, base, view, gt, deltas)
    torch.cuda.synchronize()
    assert (sig_l2_fused.launches - before[0],
            sig_l2_fused.backward_launches - before[1]) == (1, 1)
    again, dp2, dg2 = _grads(sig_l2_fused, base, view, gt, deltas)
    assert torch.equal(got, again) and torch.equal(dp, dp2) and torch.equal(dg, dg2)
    x = view(base)
    np.testing.assert_allclose(got.item(), sig_l2_plain(x, gt, deltas).item(), **TOL_VALUE)
    np.testing.assert_allclose(got.item(), sig_l2_plain(x.double(), gt.double(),
                                                        deltas).item(), **TOL_VALUE)
    _, rp, rg = _grads(sig_l2_plain, base, view, gt, deltas)
    torch.testing.assert_close(dp, rp, **TOL_GRAD)
    torch.testing.assert_close(dg, rg, **TOL_GRAD)
    gp, gg = sig_l2_backward_reference(x, gt, torch.ones((), device=dev), deltas)
    assert torch.equal(dp, gp) and torch.equal(dg, gg)


@pytest.mark.cuda
def test_cuda_c2_falls_back_and_launches_nothing():
    dev = _cuda()
    base, _, gt, deltas = _sig_case("c2")
    base, gt = base.to(dev), gt.to(dev)
    before = sig_l2_fused.launches
    np.testing.assert_allclose(sig_l2_fused(base, gt, deltas).item(),
                               sig_l2_plain(base, gt, deltas).item(), rtol=0)
    assert sig_l2_fused.launches == before


@pytest.mark.cuda
def test_cuda_backward_without_gt_gradient():
    """A label that needs no gradient: the backward writes d pred alone."""
    dev = _cuda()
    base, _, gt, deltas = _sig_case("five")
    p = base.to(dev).requires_grad_(True)
    sig_l2_fused(p, gt.to(dev), deltas).backward()
    ref, _ = sig_l2_backward_reference(base.to(dev), gt.to(dev), torch.ones((), device=dev),
                                       deltas)
    assert torch.equal(p.grad, ref)
