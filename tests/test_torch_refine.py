"""Test-time refinement in the port against the JAX package: ``sparse_scale_factor``'s
value and gradient (the midpoint median), ``refine_depth``'s first step from one init
with and without a prior depth (the loss, the parameters after Adam's first update, the
running statistics), the refined depth of the port's eval forward on JAX's final
variables, the ``"pallas"`` route's plain version on CPU tensors, and both CLIs on the
JAX test's COLMAP fixture.

JAX compiles its refinement step once per ``refine_depth`` call, so each prior setting
runs JAX's ``refine_depth`` once, in a module-scoped fixture, with its state built from the
given init and its final eval forward jitted (``_given_state``, ``_jitted_eval_dispnet``):
the same computation, fewer compiles.

B=1 train-mode batch norm: at 32x48 cnv5 is 1x2 and cnv6..cnv7b 1x1, so the deepest
batch norms see 2 and 1 values (at 1, ``x - mean`` is exactly 0 in both packages and the
layer gives its bias). The two packages' float32 train forwards then differ by up to
1.4e-4 relative in disp1 on this file's init (a CPU run), where the deepest batch norms
divide the rounding of two values' difference by their own spread, as the DeMoN families'
do (ROADMAP Queue 3, "DeMoN-stream step parity"). The loss averages that over every pixel
and is held to 1e-5; the scale, a ratio of medians that reads one or two pixels of disp1,
is held to the forward's 2e-4.
"""
import os

import numpy as np
import pytest
import torch

from test_refine_and_flow import colmap_scene  # noqa: F401 (fixture)
from torch_fixtures import drop_tmp_path  # noqa: F401 (fixture)
from tf_depth_estimation_torch.infer import refine, refine_cli
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.utils.npz import _flatten
from tf_depth_estimation_torch.weights import load_variables, module_variables

H, W, LR = 32, 48, 1e-4   # tests/test_refine_and_flow.py's size; refine_depth's rate
# the refined depth, an eval forward of float32 convolutions summed in another order
# (tests/test_fast_infer.py:37's limits), times a ratio of medians
TOL_DEPTH = dict(rtol=2e-4, atol=2e-4)
TOL_SCALE = 2e-4   # the module docstring says why


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The file runs beside other pytest workers (tests/test_torch_split.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- sparse_scale_factor -----------------------------------------------------------------

def _anchors(case: str):
    """(depth [H, W], sparse_xy [N, 2], sparse_z [N]) of ``case``."""
    rng = np.random.RandomState(3)
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    n = {"odd": 7, "even": 8, "ties": 6, "outside": 9}[case]
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1).astype(np.float32)
    z = rng.uniform(1.0, 4.0, n).astype(np.float32)
    if case == "ties":   # two anchors on one pixel, and two equal sparse depths
        xy[1] = xy[0] + 0.25
        z[2] = z[3]
    if case == "outside":  # beyond every border, and negative (truncated toward zero)
        xy[:4] = [[-3.7, 5.0], [W + 6.2, 4.0], [10.0, -0.6], [12.0, H + 0.4]]
    return depth, xy, z


@pytest.mark.parametrize("case", ["odd", "even", "ties", "outside"])
def test_sparse_scale_factor_and_gradient_match_jax(case):
    """Value and gradient (with respect to the depth and to the sparse depths) of the
    port's ``sparse_scale_factor`` against ``jax.grad`` of JAX's."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.infer.refine import sparse_scale_factor as jscale

    depth, xy, z = _anchors(case)
    ref, (ref_dd, ref_dz) = jax.value_and_grad(
        lambda d, s: jscale(d, jnp.asarray(xy), s), argnums=(0, 1))(
        jnp.asarray(depth), jnp.asarray(z))
    d_t = torch.from_numpy(depth).requires_grad_()
    z_t = torch.from_numpy(z).requires_grad_()
    got = refine.sparse_scale_factor(d_t, torch.from_numpy(xy), z_t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(ref_dd), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(z_t.grad.numpy(), np.asarray(ref_dz), rtol=1e-6, atol=1e-9)


def test_median_is_the_midpoint_at_an_even_count():
    """JAX's median of [1, 2, 3, 10] is 2.5 and its gradient [0, .5, .5, 0];
    ``torch.median`` would give 2.0."""
    x = torch.tensor([10.0, 1.0, 3.0, 2.0], requires_grad=True)
    m = refine.median(x)
    m.backward()
    assert float(m.detach()) == 2.5 and float(torch.median(x.detach())) == 2.0
    assert x.grad.tolist() == [0.0, 0.0, 0.5, 0.5]


# ---- refine_depth from one init ----------------------------------------------------------

def _pair():
    """(image1, image2, relative pose, K, sparse_xy, sparse_z, prior depth) at H x W."""
    rng = np.random.RandomState(11)
    x1 = (rng.rand(H, W, 3) * 255).astype(np.float32)
    x2 = np.roll(x1, 2, axis=1) + rng.uniform(-5, 5, (H, W, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.06, -0.02, 0.01]
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    xy = np.stack([rng.uniform(0, W, 10), rng.uniform(0, H, 10)], 1).astype(np.float32)
    z = rng.uniform(1.0, 3.0, 10).astype(np.float32)
    gt = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    return x1, x2, pose, K, xy, z, gt


class _StepRecorder:
    """Stands in for ``jax`` in JAX's refine module: ``jit`` runs the real jit and keeps
    every state the step returns."""

    def __init__(self):
        import jax

        self._jax = jax
        self.states = []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn):
        jitted = self._jax.jit(fn)

        def run(*args):
            out = jitted(*args)
            self.states.append(out[0])
            return out
        return run


def _given_state(init: dict):
    """A stand-in for JAX's ``create_train_state`` that builds the state from ``init``
    instead of tracing flax's init: the same state, since ``refine_depth`` replaces the
    params with ``init_params`` and flax's batch statistics start at 0 and 1 as the
    port's do (``init``'s). It spares a compile of the model's init."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.train import state as jstate

    def create(model, example_input, learning_rate=2e-4, beta1=0.9, rng=None):
        params = jax.tree.map(jnp.asarray, init["params"])
        tx = jstate.adam(learning_rate, beta1)
        return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=jax.tree.map(jnp.asarray, init["batch_stats"]),
                                 opt_state=tx.init(params), tx=tx, apply_fn=model.apply)
    return create


def _jitted_eval_dispnet():
    """JAX's DispNet whose eval ``apply`` (``refine_depth``'s final forward, op by op in
    the JAX module) runs under ``jax.jit``: the same function, one compile instead of one
    a primitive."""
    import jax

    from tf_depth_estimation_tpu.models import DispNet as JDispNet

    class JitEvalDispNet(JDispNet):
        def apply(self, variables, *args, train=True, **kwargs):
            if train:
                return super().apply(variables, *args, train=True, **kwargs)
            return jax.jit(lambda v, *a: JDispNet.apply(self, v, *a, train=False))(
                variables, *args)
    return JitEvalDispNet


@pytest.fixture(scope="module", params=[False, True], ids=["no_prior", "prior"])
def refined(request):
    """JAX's ``refine_depth`` for 2 steps from a seeded init (the port's, as a JAX tree)
    with the states of both steps, and the port's first step from the same init."""
    import jax

    from tf_depth_estimation_tpu.infer import refine as jrefine

    x1, x2, pose, K, xy, z, gt = _pair()
    gt = gt if request.param else None
    init = module_variables(DispNet(DispNetVariant.depth4(),
                                    generator=torch.Generator().manual_seed(7)))
    recorder = _StepRecorder()
    names = ("jax", "create_train_state", "DispNet")
    saved = [getattr(jrefine, n) for n in names]
    for n, v in zip(names, (recorder, _given_state(init), _jitted_eval_dispnet())):
        setattr(jrefine, n, v)
    try:
        depth, hist = jrefine.refine_depth(x1, x2, pose, K, xy, z, gt_depth=gt, steps=2,
                                           learning_rate=LR, init_params=init["params"])
    finally:
        for n, v in zip(names, saved):
            setattr(jrefine, n, v)
    assert len(recorder.states) == 2
    as_np = lambda tree: _flatten(jax.tree.map(np.asarray, tree))
    ref = {"depth": depth, "loss": hist["loss"], "scale": hist["scale"],
           "params1": as_np(recorder.states[0].params),
           "stats1": as_np(recorder.states[0].batch_stats),
           "final": {k: jax.tree.map(np.asarray, getattr(recorder.states[1], k))
                     for k in ("params", "batch_stats")}}
    inputs = refine.refine_inputs(x1, x2, pose, K, xy, z, gt, device="cpu")
    state = refine.refine_state(learning_rate=LR, init_params=init["params"], device="cpu")
    state, metrics = refine.make_refine_step()(state, inputs)
    variables = state.variables()
    got = {"loss": float(metrics["total"]), "scale": float(metrics["scale"]),
           "params1": _flatten(variables["params"]),
           "stats1": _flatten(variables["batch_stats"]), "inputs": inputs}
    return got, ref, _flatten(init["params"])


def test_refine_first_loss_and_scale_match_jax(refined):
    got, ref, _ = refined
    assert len(ref["loss"]) == len(ref["scale"]) == 1   # JAX records step 0 of 2
    np.testing.assert_allclose(got["loss"], ref["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got["scale"], ref["scale"][0], rtol=TOL_SCALE)


def test_refine_params_after_first_step_match_jax(refined):
    """Every parameter within 2 lr of JAX's after Adam's first update, all but 1 % within
    1e-6 (tests/test_torch_train.py's rule)."""
    got, ref, init = refined
    assert sorted(got["params1"]) == sorted(ref["params1"])
    total = off = 0
    for k, v in ref["params1"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params1"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


def test_refine_batch_stats_after_first_step_match_jax(refined):
    """Running statistics after the train forward (tests/test_torch_train.py's limits)."""
    got, ref, _ = refined
    assert sorted(got["stats1"]) == sorted(ref["stats1"])
    for k, v in ref["stats1"].items():
        np.testing.assert_allclose(got["stats1"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def test_refined_depth_on_jax_variables_matches_jax(refined):
    """The port's eval forward and scale (``refine_result``) on JAX's final variables
    against JAX's refined depth."""
    got, ref, _ = refined
    state = refine.refine_state(device="cpu")
    load_variables(state.model, ref["final"])
    depth = refine.refine_result(state, got["inputs"])
    assert depth.shape == (H, W) and depth.dtype == np.float32
    np.testing.assert_allclose(depth, ref["depth"], **TOL_DEPTH)


@pytest.mark.parametrize("prior", [False, True], ids=["no_prior", "prior"])
def test_pallas_route_on_cpu_tensors_is_the_plain_sampler(prior):
    """On CPU tensors ``sampler="pallas"`` runs the plain version: two steps bit-equal to
    ``"xla"``'s, with the same history and refined depth."""
    x1, x2, pose, K, xy, z, gt = _pair()
    runs = [refine.refine_depth(x1, x2, pose, K, xy, z, gt_depth=gt if prior else None,
                                steps=2, seed=3, sampler=s, device="cpu")
            for s in ("pallas", "xla")]
    assert runs[0][1] == runs[1][1]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])


# ---- the CLIs ---------------------------------------------------------------------------

def test_refine_clis_give_the_same_problem(colmap_scene, tmp_path,  # noqa: F811
                                           monkeypatch):
    """Both CLIs for 2 steps on the JAX test's COLMAP model: the same images, relative
    pose, intrinsics and sparse anchors reach ``refine_depth`` (JAX's stands in by a
    recorder: its own test runs it), and the port's writes a finite ``.bin`` of H x W."""
    from tf_depth_estimation_tpu.infer import refine as jrefine
    from tf_depth_estimation_tpu.infer import refine_cli as jrefine_cli

    model_dir, image_dir = colmap_scene
    calls = {}

    def recorder(name, fn=None):
        def run(*args, **kwargs):
            calls[name] = (args, kwargs)
            if fn is None:
                return np.zeros((H, W), np.float32), {"loss": [], "scale": []}
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(jrefine, "refine_depth", recorder("jax"))
    monkeypatch.setattr(refine, "refine_depth", recorder("port", refine.refine_depth))
    argv = ["--model_dir", model_dir, "--image_dir", image_dir, "--image1", "a.jpg",
            "--image2", "b.jpg", "--steps", "2", "--height", str(H), "--width", str(W)]
    jrefine_cli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    depth, hist = refine_cli.main(argv + ["--output_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    (jargs, jkw), (args, kw) = calls["jax"], calls["port"]
    assert len(jargs) == len(args) == 6
    for a, b in zip(jargs, args):   # images, relative pose, K, sparse xy, sparse z
        np.testing.assert_array_equal(a, b)
    assert kw.pop("device") == "cpu" and kw == jkw
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"] + hist["scale"]).all()
    out = tmp_path / "port" / "a.jpg_refined_z.bin"
    z = np.fromfile(out, np.float32)
    assert z.size == H * W and np.isfinite(z).all() and (z > 0).all()
    np.testing.assert_array_equal(z.reshape(H, W), depth)


def test_refine_cli_needs_a_card_unless_told_cpu(colmap_scene, tmp_path):  # noqa: F811
    """Without ``--device cpu`` the CLI runs on ``cuda`` and raises where there is no
    card, rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    model_dir, image_dir = colmap_scene
    with pytest.raises((RuntimeError, AssertionError)):
        refine_cli.main(["--model_dir", model_dir, "--image_dir", image_dir, "--image1",
                         "a.jpg", "--image2", "b.jpg", "--steps", "1", "--height", str(H),
                         "--width", str(W), "--output_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")
