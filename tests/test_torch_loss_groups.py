"""The grouped loss wrappers, ``smoothness_fused_group`` and ``sig_l2_fused_group``: on the
CPU (the plain versions map by map) against the coefficient-weighted sum of JAX's
``smoothness_fused`` / ``sig_l2_fused`` (the Pallas kernels in interpret mode, or their
plain fallbacks) and against the port's single-map plain versions, in value and in each
map's gradient. The groups mix sizes, NCHW channel views, maps outside the kernels' rule
(C=2), deltas longer than a side and a NaN coefficient (the sig ramp below 3 steps). A
map of H < 3 or W < 3, outside the smoothness kernel's rule too, has an empty mean, NaN in
both packages; ``tests/test_torch_depth_only.py`` holds it alone. The ``cuda`` tests hold
the group kernels to the plain versions on the card at a config-4 step's and a
split_training step's shapes: the same bits in two runs, one launch each way, two groups
on two streams at once, and the cap on maps.

JAX is imported inside the fixtures that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.losses.basic import second_order_smoothness
from tf_depth_estimation_torch.ops import schedules
from tf_depth_estimation_torch.ops import sig_l2 as sg
from tf_depth_estimation_torch.ops import smoothness as sm
from tf_depth_estimation_torch.ops.sig import sig_l2_plain

# tests/test_pallas.py:56,69: value rtol 1e-5; gradients within 1e-6 of each map's max|g|
TOL_VALUE = dict(rtol=1e-5)
TOL_GRAD = 1e-6
FIVE = (1, 2, 4, 8, 16)


def _u(rng, *shape, lo=0.5, hi=2.0):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _smooth_group(name, seed=0):
    """(bases, views, coefs): map k is views[k](bases[k]), a float32 CPU tensor."""
    rng = np.random.RandomState(seed)
    same = lambda t: t
    if name == "mixed":
        bases = [_u(rng, 2, 24, 32, 1), _u(rng, 2, 2, 12, 20, lo=-2), _u(rng, 1, 7, 9, 1),
                 _u(rng, 2, 8, 10, 2)]
        views = [same, lambda t: _nhwc(t)[..., 1:2], same, same]
        return bases, views, [1.0, 0.5, 0.25, 2.0]
    # a config-4 step's twelve maps at 32x48: per scale the depth head and both channels
    # of the flow head, NCHW viewed NHWC, at smooth_weight / 2**s
    bases, views, coefs = [], [], []
    for s in range(4):
        h, w = 32 >> s, 48 >> s
        depth, flow = _u(rng, 2, 1, h, w), _u(rng, 2, 2, h, w, lo=-2)
        bases += [depth, flow, flow]
        views += [_nhwc, lambda t: _nhwc(t)[..., 0:1], lambda t: _nhwc(t)[..., 1:2]]
        coefs += [0.5 / 2**s] * 3
    return bases, views, coefs


def _sig_group(name, seed=0):
    """(bases, views, gts, deltas, coefs): pred k is views[k](bases[k])."""
    rng = np.random.RandomState(seed)
    same = lambda t: t
    if name == "mixed":
        bases = [_u(rng, 2, 24, 32, 1), _u(rng, 2, 2, 24, 32), _u(rng, 2, 6, 16, 1),
                 _u(rng, 2, 12, 16, 2)]
        views = [same, lambda t: _nhwc(t)[..., 1:2], same, same]
        gts = [_u(rng, 2, 24, 32, 1), _u(rng, 2, 24, 32, 1), _u(rng, 2, 6, 16, 1),
               _u(rng, 2, 12, 16, 2)]
        return bases, views, gts, FIVE, [1.0, 0.5, 0.25, 2.0]
    # split_training's phase 2 at 32x48, B=1, delta 2: four scales at the ramped weight;
    # "nan": at step 0 of a run of fewer than 3 steps, whose ramp is 0/0 in both packages
    bases = [_u(rng, 1, 32 >> s, 48 >> s, 1) for s in range(4)]
    gts = [_u(rng, 1, 32 >> s, 48 >> s, 1) for s in range(4)]
    with np.errstate(divide="ignore", invalid="ignore"):
        weight = schedules.ease_out_quad(0 if name == "nan" else 5, 0.0, 1000.0,
                                         float((2 if name == "nan" else 300) // 3))
    return bases, [same] * 4, gts, (2,), [weight] * 4


SMOOTH_GROUPS = ["mixed", "config4"]
SIG_GROUPS = ["mixed", "phase2", "nan"]


def _leaves(bases):
    return [b.detach().clone().requires_grad_(True) for b in bases]


def _smooth_port(fn, name):
    """(total, per_map, each map's gradient of total) of ``fn(maps, coefs)``."""
    bases, views, coefs = _smooth_group(name)
    leaves = _leaves(bases)
    total, per_map = fn([v(b) for v, b in zip(views, leaves)], coefs)
    # maps that are views of one base (the flow channels) share its gradient: take each
    # map's own through its view of d total / d base
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return total.detach(), per_map.detach(), [v(g) for v, g in zip(views, grads)]


def _single_smooth_sum(maps, coefs):
    per_map = [sm.smoothness_fused(m) for m in maps]
    return sum(c * v for c, v in zip(coefs, per_map)), torch.stack(per_map)


def _within(got, ref, tol=TOL_GRAD):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol * float(np.abs(np.asarray(ref)).max()))


@pytest.fixture(scope="module", params=SMOOTH_GROUPS)
def smooth_jax(request):
    """name -> (total, per_map, each map's gradient of total) through JAX's
    ``smoothness_fused`` in interpret mode (its fallback outside the rule)."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_losses import smoothness_fused as jfused

    bases, views, coefs = _smooth_group(request.param)
    maps = [jnp.asarray(np.ascontiguousarray(v(b).numpy())) for v, b in zip(views, bases)]

    def total(ms):
        terms = [jfused(m, True) for m in ms]
        return sum(c * t for c, t in zip(coefs, terms)), terms

    (value, per_map), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(maps)
    return (request.param, float(value), [float(t) for t in per_map],
            [np.asarray(g) for g in grads])


def test_smoothness_group_matches_jax(smooth_jax):
    name, total, per_map, grads = smooth_jax
    got, got_per_map, got_grads = _smooth_port(sm.smoothness_fused_group, name)
    np.testing.assert_allclose(got.item(), total, **TOL_VALUE)
    np.testing.assert_allclose(got_per_map.numpy(), per_map, **TOL_VALUE)
    for g, ref in zip(got_grads, grads):
        _within(g.numpy(), ref)


@pytest.mark.parametrize("name", SMOOTH_GROUPS)
def test_smoothness_group_matches_single_map_plain_terms(name):
    """The group against the single-map functions on the same maps: total, terms and
    each map's gradient."""
    got = _smooth_port(sm.smoothness_fused_group, name)
    ref = _smooth_port(_single_smooth_sum, name)
    np.testing.assert_allclose(got[0].item(), ref[0].item(), **TOL_VALUE)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    for g, r in zip(got[2], ref[2]):
        _within(g.numpy(), r.numpy())


def test_smoothness_group_gradient_of_a_term():
    """A loss that also takes one map's term: that map's gradient adds the term's."""
    bases, views, coefs = _smooth_group("mixed")
    leaf = _leaves(bases[:1])[0]
    total, per_map = sm.smoothness_fused_group([leaf, views[1](bases[1])], coefs[:2])
    (grad,) = torch.autograd.grad(total + 3.0 * per_map[0], leaf)
    ref = sm.smoothness_backward_reference(leaf.detach(), torch.tensor(coefs[0] + 3.0))
    _within(grad.numpy(), ref.numpy())


def test_smoothness_group_refuses_what_it_does_not_take():
    x = torch.ones(1, 8, 8, 1)
    with pytest.raises(ValueError):
        sm.smoothness_fused_group([x] * (sm.MAX_MAPS + 1), [1.0] * (sm.MAX_MAPS + 1))
    with pytest.raises(ValueError):
        sm.smoothness_fused_group([], [])
    with pytest.raises(ValueError):
        sm.smoothness_fused_group([x, x], [1.0])
    with pytest.raises(TypeError):
        sm.smoothness_fused_group([x, x.double()], [1.0, 1.0])


def _sig_port(fn, name):
    """(total, per_map, d pred of each pair, d gt of each pair) of
    ``fn(preds, gts, deltas, coefs)``."""
    bases, views, gts, deltas, coefs = _sig_group(name)
    leaves, gleaves = _leaves(bases), _leaves(gts)
    total, per_map = fn([v(b) for v, b in zip(views, leaves)], gleaves, deltas, coefs)
    grads = torch.autograd.grad(total, leaves + gleaves)
    dp = [v(g) for v, g in zip(views, grads[:len(bases)])]
    return total.detach(), per_map.detach(), dp, list(grads[len(bases):])


def _single_sig_sum(preds, gts, deltas, coefs):
    per_map = [sg.sig_l2_fused(p, g, deltas) for p, g in zip(preds, gts)]
    return sum(c * v for c, v in zip(coefs, per_map)), torch.stack(per_map)


@pytest.fixture(scope="module", params=SIG_GROUPS)
def sig_jax(request):
    """name -> (total, per_map, d pred and d gt of each pair) through JAX's
    ``sig_l2_fused`` in interpret mode (its fallback for C=2), the coefficient of the
    NaN group from JAX's own ramp."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops import schedules as jschedules
    from tf_depth_estimation_tpu.ops.pallas_losses import sig_l2_fused as jsig

    bases, views, gts, deltas, coefs = _sig_group(request.param)
    if request.param == "nan":
        coefs = [float(jschedules.ease_out_quad(0, 0.0, 1000.0, float(2 // 3)))] * len(gts)
    preds = [jnp.asarray(np.ascontiguousarray(v(b).numpy())) for v, b in zip(views, bases)]
    labels = [jnp.asarray(g.numpy()) for g in gts]
    def total(ps, gs):
        terms = [jsig(p, g, deltas, 0.001, 1e-6, True) for p, g in zip(ps, gs)]
        return sum(c * t for c, t in zip(coefs, terms)), terms

    (value, per_map), (dp, dg) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(preds, labels)
    return (request.param, float(value), [float(t) for t in per_map],
            [np.asarray(g) for g in dp], [np.asarray(g) for g in dg])


def test_sig_group_matches_jax(sig_jax):
    name, total, per_map, dps, dgs = sig_jax
    got, got_per_map, got_dp, got_dg = _sig_port(sg.sig_l2_fused_group, name)
    np.testing.assert_allclose(got_per_map.numpy(), per_map, **TOL_VALUE)
    if name == "nan":   # 0/0 times each term, in both packages
        assert np.isnan(total) and np.isnan(got.item())
        assert all(np.isnan(g).all() for g in dps + dgs)
        assert all(torch.isnan(g).all() for g in got_dp + got_dg)
        return
    np.testing.assert_allclose(got.item(), total, **TOL_VALUE)
    for g, ref in zip(got_dp + got_dg, dps + dgs):
        _within(g.numpy(), ref)


@pytest.mark.parametrize("name", SIG_GROUPS)
def test_sig_group_matches_single_map_plain_terms(name):
    """The group against the single-map functions on the same pairs: total, terms and
    each map's gradients (NaN where the coefficient is NaN, in both)."""
    got = _sig_port(sg.sig_l2_fused_group, name)
    ref = _sig_port(_single_sig_sum, name)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(got[0].item(), ref[0].item(), equal_nan=True, **TOL_VALUE)
    for g, r in zip(got[2] + got[3], ref[2] + ref[3]):
        if name == "nan":
            assert torch.isnan(g).all() and torch.isnan(r).all()
        else:
            _within(g.numpy(), r.numpy())


@pytest.mark.parametrize("name", ["mixed", "phase2"])
def test_sig_group_gradient_is_the_gather_formula_at_each_coefficient(name):
    """Each C=1 pair's gradients are ``sig_l2_backward_reference`` at the cotangent
    ``coef`` (the backward kernel's formula), within 1e-6 of max|g|."""
    bases, views, gts, deltas, coefs = _sig_group(name)
    _, _, dps, dgs = _sig_port(sg.sig_l2_fused_group, name)
    for b, v, g, c, dp, dg in zip(bases, views, gts, coefs, dps, dgs):
        if g.shape[-1] != 1:
            continue
        rp, rg = sg.sig_l2_backward_reference(v(b), g, torch.tensor(c), deltas)
        _within(dp.numpy(), rp.numpy())
        _within(dg.numpy(), rg.numpy())


def test_sig_group_refuses_what_it_does_not_take():
    x = torch.ones(1, 8, 8, 1)
    n = sg.MAX_MAPS + 1
    with pytest.raises(ValueError):
        sg.sig_l2_fused_group([x] * n, [x] * n, (2,), [1.0] * n)
    with pytest.raises(ValueError):
        sg.sig_l2_fused_group([x, x], [x], (2,), [1.0, 1.0])
    with pytest.raises(ValueError):
        sg.sig_l2_fused_group([x], [x], tuple(range(1, sg.MAX_DELTAS + 2)), [1.0])
    with pytest.raises(ValueError):
        sg.sig_l2_fused_group([x], [x[:, :-1]], (2,), [1.0])


def test_host_cost_tool_has_no_cpu_path():
    """``tools/loss_host_cost.py`` measures the card: without one it exits non-zero."""
    from tf_depth_estimation_torch.tools import loss_host_cost

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs instead")
    with pytest.raises(SystemExit):
        loss_host_cost.main()


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _config4_maps(dev, seed=1):
    """A config-4 step's twelve smoothness maps (B=10, 224x480 down to 28x60): per scale the
    depth head and both channels of the flow head, NCHW viewed NHWC, and their
    coefficients; the maps are views of leaves."""
    rng = np.random.RandomState(seed)
    leaves, maps, coefs = [], [], []
    for s in range(4):
        h, w = 224 >> s, 480 >> s
        depth = _u(rng, 10, 1, h, w, lo=0, hi=4).to(dev).requires_grad_(True)
        flow = _u(rng, 10, 2, h, w, lo=-3, hi=3).to(dev).requires_grad_(True)
        leaves += [depth, flow]
        maps += [_nhwc(depth), _nhwc(flow)[..., 0:1], _nhwc(flow)[..., 1:2]]
        coefs += [0.5 / 2**s] * 3
    return leaves, maps, coefs


def _phase_pairs(dev, scales=range(4), seed=2):
    """split_training's sig pairs at 192x256, B=1 (phase 2: scales 0-3; phase 1: 2 and 3):
    disparities and inverse-depth labels, each a leaf."""
    rng = np.random.RandomState(seed)
    preds = [_u(rng, 1, 192 >> s, 256 >> s, 1, lo=0.05, hi=4).to(dev).requires_grad_(True)
             for s in scales]
    gts = [(1 / _u(rng, 1, 192 >> s, 256 >> s, 1, lo=0.4, hi=2.5)).to(dev)
           .requires_grad_(True) for s in scales]
    return preds, gts


def _smooth_run(maps, coefs, leaves, extra=0.0):
    total, per_map = sm.smoothness_fused_group(maps, coefs)
    grads = torch.autograd.grad(total + extra * per_map[0], leaves)
    return total.detach(), per_map.detach(), grads


@pytest.mark.cuda
def test_cuda_smoothness_group_at_a_config4_step():
    """One launch each way for the twelve maps; the same bits twice; total and terms
    within rtol 1e-5 of the plain terms in float32 and float64; each leaf's gradient
    within 1e-6 of max|g| of autograd of the plain group, also with a term's own
    cotangent."""
    dev = _cuda()
    leaves, maps, coefs = _config4_maps(dev)
    before = (sm.smoothness_fused.launches, sm.smoothness_fused.backward_launches)
    got = _smooth_run(maps, coefs, leaves)
    torch.cuda.synchronize()
    assert (sm.smoothness_fused.launches - before[0],
            sm.smoothness_fused.backward_launches - before[1]) == (1, 1)
    again = _smooth_run(maps, coefs, leaves)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], again[2]))
    total, per_map = sm.smoothness_plain_group(maps, coefs)
    ref_grads = torch.autograd.grad(total, leaves)
    terms64 = [second_order_smoothness(m.double()).item() for m in maps]
    np.testing.assert_allclose(got[1].cpu().numpy(), per_map.detach().cpu().numpy(),
                               **TOL_VALUE)
    np.testing.assert_allclose(got[1].cpu().numpy(), terms64, **TOL_VALUE)
    np.testing.assert_allclose(got[0].item(), total.item(), **TOL_VALUE)
    np.testing.assert_allclose(got[0].item(), sum(c * t for c, t in zip(coefs, terms64)),
                               **TOL_VALUE)
    for g, r in zip(got[2], ref_grads):
        _within(g.cpu().numpy(), r.cpu().numpy())
    with_term = _smooth_run(maps, coefs, leaves, extra=2.0)
    total, per_map = sm.smoothness_plain_group(maps, coefs)
    for g, r in zip(with_term[2], torch.autograd.grad(total + 2.0 * per_map[0], leaves)):
        _within(g.cpu().numpy(), r.cpu().numpy())


def _sig_run(preds, gts, deltas, coefs):
    total, per_map = sg.sig_l2_fused_group(preds, gts, deltas, coefs)
    grads = torch.autograd.grad(total, preds + gts)
    return total.detach(), per_map.detach(), grads


@pytest.mark.cuda
@pytest.mark.parametrize("phase,scales", [("phase1", (2, 3)), ("phase2", (0, 1, 2, 3))])
def test_cuda_sig_group_at_a_split_training_step(phase, scales):
    """One launch each way for the step's pairs; the same bits twice; total and terms
    within rtol 1e-5 of the plain composition in float32 and float64; d pred and d gt of
    each pair bit-equal to the gather formula at the cotangent ``coef`` and within 1e-6
    of max|g| of autograd of the plain group."""
    dev = _cuda()
    preds, gts = _phase_pairs(dev, scales)
    coefs = [0.8] * len(preds)
    before = (sg.sig_l2_fused.launches, sg.sig_l2_fused.backward_launches)
    got = _sig_run(preds, gts, (2,), coefs)
    torch.cuda.synchronize()
    assert (sg.sig_l2_fused.launches - before[0],
            sg.sig_l2_fused.backward_launches - before[1]) == (1, 1)
    again = _sig_run(preds, gts, (2,), coefs)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], again[2]))
    total, per_map = sg.sig_l2_plain_group(preds, gts, (2,), coefs)
    ref_grads = torch.autograd.grad(total, preds + gts)
    terms64 = [sig_l2_plain(p.double(), g.double(), (2,)).item() for p, g in zip(preds, gts)]
    np.testing.assert_allclose(got[1].cpu().numpy(), per_map.detach().cpu().numpy(),
                               **TOL_VALUE)
    np.testing.assert_allclose(got[1].cpu().numpy(), terms64, **TOL_VALUE)
    np.testing.assert_allclose(got[0].item(), total.item(), **TOL_VALUE)
    for g, r in zip(got[2], ref_grads):
        _within(g.cpu().numpy(), r.cpu().numpy())
    K = len(preds)
    for k in range(K):
        rp, rg = sg.sig_l2_backward_reference(
            preds[k].detach(), gts[k].detach(), torch.tensor(coefs[k], device=dev), (2,))
        assert torch.equal(got[2][k], rp) and torch.equal(got[2][K + k], rg)


@pytest.mark.cuda
def test_cuda_groups_on_two_streams_at_once():
    """A config-4 smoothness group and a phase-2 sig group, each launched on its own
    stream without a synchronisation between them, five times: every result has the
    bits of the same group run alone."""
    dev = _cuda()
    leaves, maps, coefs = _config4_maps(dev)
    preds, gts = _phase_pairs(dev)
    alone_s = sm.smoothness_fused_group(maps, coefs)[0].detach()
    alone_g = sg.sig_l2_fused_group(preds, gts, (2,), [0.8] * 4)[0].detach()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(5):
        with torch.cuda.stream(streams[0]):
            a = sm.smoothness_fused_group(maps, coefs)[0].detach()
            a2 = sg.sig_l2_fused_group(preds, gts, (2,), [0.8] * 4)[0].detach()
        with torch.cuda.stream(streams[1]):
            b = sg.sig_l2_fused_group(preds, gts, (2,), [0.8] * 4)[0].detach()
            b2 = sm.smoothness_fused_group(maps, coefs)[0].detach()
        outs.append((a, a2, b, b2))
    torch.cuda.synchronize()
    for a, a2, b, b2 in outs:
        assert torch.equal(a, alone_s) and torch.equal(b2, alone_s)
        assert torch.equal(a2, alone_g) and torch.equal(b, alone_g)


@pytest.mark.cuda
def test_cuda_mixed_group_launches_once_each_way():
    """A group with a C=2 map: the eligible maps in one launch each way,
    the others through the plain term; total and gradients as the plain group's."""
    dev = _cuda()
    bases, views, coefs = _smooth_group("mixed")
    leaves = [b.to(dev).requires_grad_(True) for b in bases]
    maps = [v(b) for v, b in zip(views, leaves)]
    before = (sm.smoothness_fused.launches, sm.smoothness_fused.backward_launches)
    total, per_map = sm.smoothness_fused_group(maps, coefs)
    grads = torch.autograd.grad(total, leaves)
    torch.cuda.synchronize()
    assert (sm.smoothness_fused.launches - before[0],
            sm.smoothness_fused.backward_launches - before[1]) == (1, 1)
    ref, ref_per_map = sm.smoothness_plain_group(maps, coefs)
    np.testing.assert_allclose(per_map.detach().cpu().numpy(),
                               ref_per_map.detach().cpu().numpy(), **TOL_VALUE)
    np.testing.assert_allclose(total.item(), ref.item(), **TOL_VALUE)
    for g, r in zip(grads, torch.autograd.grad(ref, leaves)):
        _within(g.cpu().numpy(), r.cpu().numpy())


@pytest.mark.cuda
def test_cuda_groups_refuse_past_the_cap_and_launch_nothing():
    dev = _cuda()
    x = torch.ones(1, 8, 8, 1, device=dev)
    before = (sm.smoothness_fused.launches, sg.sig_l2_fused.launches)
    with pytest.raises(ValueError):
        sm.smoothness_fused_group([x] * (sm.MAX_MAPS + 1), [1.0] * (sm.MAX_MAPS + 1))
    n = sg.MAX_MAPS + 1
    with pytest.raises(ValueError):
        sg.sig_l2_fused_group([x] * n, [x] * n, (2,), [1.0] * n)
    assert (sm.smoothness_fused.launches, sg.sig_l2_fused.launches) == before
    # the kernels' own caps are the wrappers'
    sm._lib(), sg._lib()
