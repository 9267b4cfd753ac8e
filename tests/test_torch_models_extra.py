"""PoseExpNet, UpconvNet and the flow-augmented predictor in the port against the JAX
package: train and eval forwards and the running statistics a train forward leaves, from
one seeded init carried across by the weight bridge (its statistics moved off 0 and 1),
at ``tests/test_models.py``'s shapes (B=1, 96x128); the bridge's loaders and round trips
of both nets and of the 11-channel DepthPoseNet; ``FlowAugmentedPredictor``'s input
assembly and its predictions, module and folded forward, on 3 frames at batch 2 (the
ragged tail), at ``tests/test_refine_and_flow.py``'s 32x48; and its bf16 answers on
``chip_smoke.py``'s phase-43 net and inputs (192x256, B=16) in both packages, which is
where that phase's limit comes from.
"""
import functools

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.infer.predictor import FlowAugmentedPredictor
from tf_depth_estimation_torch.models import DepthPoseNet, PoseExpNet, UpconvNet
from tf_depth_estimation_torch.utils.npz import _flatten, _unflatten
from tf_depth_estimation_torch.weights import (
    depth_pose_from_variables,
    module_variables,
    pose_exp_from_variables,
    state_dict_to_variables,
    upconv_from_variables,
)

H, W = 96, 128    # tests/test_models.py
FH, FW = 32, 48   # tests/test_refine_and_flow.py
# float32 forwards: the same products summed in another order (tests/test_fast_infer.py:37)
TOL_FWD = dict(rtol=2e-4, atol=2e-4)
# running statistics after a train forward (tests/test_torch_train.py)
TOL_STATS = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The file runs beside other pytest workers (tests/test_torch_split.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _moved(model: torch.nn.Module, seed: int) -> dict:
    """``model``'s JAX variables tree with its batch statistics moved off 0 / 1, so that
    an eval forward reads them."""
    tree = module_variables(model)
    rng = np.random.RandomState(seed)
    tree["batch_stats"] = _unflatten({
        k: (v + rng.uniform(-0.2, 0.2, v.shape) if k.endswith("mean")
            else v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in _flatten(tree["batch_stats"]).items()})
    return tree


def _jax_apply(module, tree, inputs, train):
    """(JAX outputs, its batch statistics after a train forward or None)."""
    import jax
    import jax.numpy as jnp

    variables = jax.tree.map(jnp.asarray, tree)
    if train:
        out, mutated = jax.jit(lambda v, x: module.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, inputs)
        return out, _flatten(jax.tree.map(np.asarray, dict(mutated["batch_stats"])))
    return jax.jit(functools.partial(module.apply, train=False))(variables, inputs), None


def _hold_stats(model: torch.nn.Module, want: dict):
    got = _flatten(module_variables(model)["batch_stats"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **TOL_STATS, err_msg=k)


# ---- PoseExpNet --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False], ids=["exp", "no_exp"])
def pose_exp(request):
    """(do_exp, a seeded PoseExpNet(num_source=2) as a JAX tree, a [1, H, W, 9] input)."""
    model = PoseExpNet(num_source=2, do_exp=request.param,
                       generator=torch.Generator().manual_seed(2))
    x = np.random.RandomState(4).uniform(0, 255, (1, H, W, 9)).astype(np.float32)
    return request.param, _moved(model, 6), x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pose_exp_net_matches_jax(pose_exp, train):
    """Pose and masks of ``pose_exp_from_variables`` against JAX's PoseExpNet on the same
    tree, and the running statistics a train forward leaves."""
    from tf_depth_estimation_tpu.models import PoseExpNet as JPoseExpNet

    do_exp, tree, x = pose_exp
    (ref_pose, ref_masks), stats = _jax_apply(JPoseExpNet(num_source=2, do_exp=do_exp),
                                              tree, x, train)
    model = pose_exp_from_variables(tree, device="cpu")
    assert (model.num_source, model.do_exp) == (2, do_exp)
    model.train(train)
    with torch.no_grad():
        pose, masks = model.forward_nhwc(torch.from_numpy(x))
    assert pose.shape == (1, 2, 6)
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref_pose), **TOL_FWD)
    assert len(masks) == len(ref_masks) == 4
    for m, r in zip(masks, ref_masks):
        if not do_exp:
            assert m is None and r is None
            continue
        np.testing.assert_allclose(m.numpy(), np.asarray(r), **TOL_FWD)
    assert do_exp is False or masks[0].shape == (1, H, W, 4)
    if train:
        _hold_stats(model, stats)


# ---- UpconvNet ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def upconv():
    """(a seeded UpconvNet over 2048-channel r0 as a JAX tree, its five endpoints
    [1, h, w, c] at test_models.py's sizes)."""
    model = UpconvNet(in_channels=2048, generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(8)
    eps = [rng.uniform(-1, 1, (1, H // f, W // f, c)).astype(np.float32)
           for c, f in ((2048, 32), (512, 16), (256, 8), (64, 4), (64, 2))]
    return _moved(model, 9), eps


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_upconv_net_matches_jax(upconv, train):
    """The four heads of ``upconv_from_variables`` against JAX's UpconvNet on the same
    tree (disp3 at the +1-pixel size), and the running statistics a train forward
    leaves."""
    from tf_depth_estimation_tpu.models import UpconvNet as JUpconvNet

    tree, eps = upconv
    ref, stats = _jax_apply(JUpconvNet(), tree, eps, train)
    model = upconv_from_variables(tree, device="cpu")
    model.train(train)
    with torch.no_grad():
        got = model.forward_nhwc([torch.from_numpy(e) for e in eps])
    assert [tuple(g.shape) for g in got] == [np.shape(r) for r in ref]
    assert got[2].shape == (1, H // 4 + 1, W // 4 + 1, 1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL_FWD)
    if train:
        _hold_stats(model, stats)


def test_upconv_laterals_round_trip_as_plain_convs(upconv):
    """``module_variables`` keeps UpconvNet's ``upcnv`` laterals ``Conv_0`` (they are 1x1
    convs, not transposed ones) and gives back the tree it loaded; the bare state-dict
    bridge, which cannot tell, takes them as transposed."""
    tree, _ = upconv
    model = upconv_from_variables(tree, device="cpu")
    back, want = _flatten(module_variables(model)), _flatten(tree)
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    assert "params/upcnv5/Conv_0/kernel" in back
    assert "params/upcnv5/TFConvTranspose_0/kernel" in _flatten(
        state_dict_to_variables(model.state_dict()))


# ---- the flow-augmented predictor --------------------------------------------------------

@pytest.fixture(scope="module")
def flow_net():
    """(a seeded truncated DepthPoseNet over 11 channels as a JAX tree, 3 assembled
    inputs [3, FH, FW, 11] from numpy-seeded frames and flows)."""
    tree = _moved(DepthPoseNet(in_channels=11, generator=torch.Generator().manual_seed(5)),
                  10)
    rng = np.random.RandomState(23)
    inputs = np.stack([FlowAugmentedPredictor.assemble_input(
        rng.rand(FH, FW, 3).astype(np.float32) * 255,
        rng.rand(FH, FW, 3).astype(np.float32) * 255,
        rng.uniform(-2, 2, (FH, FW, 2)).astype(np.float32)) for _ in range(3)])
    return tree, inputs


def test_assemble_input_equals_jax():
    """The 11-channel input [I | I1 | flow | warp(I1, flow)] of the port's NumPy sampler
    equals JAX's bit for bit."""
    from tf_depth_estimation_tpu.infer import FlowAugmentedPredictor as JFlow

    rng = np.random.RandomState(31)
    I, I1 = (rng.rand(FH, FW, 3).astype(np.float32) * 255 for _ in range(2))
    flow = rng.uniform(-3, 3, (FH, FW, 2)).astype(np.float32)
    got = FlowAugmentedPredictor.assemble_input(I, I1, flow)
    assert got.shape == (FH, FW, 11) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JFlow.assemble_input(I, I1, flow))


def test_flow_predictor_matches_jax(flow_net):
    """3 frames at batch 2 through the port's module and folded forwards (float32)
    against JAX's FlowAugmentedPredictor (its folded forward: the tree has batch
    statistics)."""
    import jax

    from tf_depth_estimation_tpu.infer import FlowAugmentedPredictor as JFlow

    tree, inputs = flow_net
    jp = JFlow(tree["params"], tree["batch_stats"], height=FH, width=FW, batch_size=2,
               dtype=jax.numpy.float32)
    ref = jp.predict(inputs)
    assert ref.shape == (3, FH // 4, FW // 4)
    for use_fast in (False, True):
        pred = FlowAugmentedPredictor(tree["params"], tree["batch_stats"], height=FH,
                                      width=FW, batch_size=2, dtype=torch.float32,
                                      use_fast=use_fast, device="cpu")
        assert pred.uses_fast_path == use_fast
        got = pred.predict(inputs)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, **TOL_FWD, err_msg=f"use_fast={use_fast}")
    with pytest.raises(ValueError, match="11"):
        pred.predict(inputs[..., :6])


def test_depth_pose_from_variables_reads_the_input_channels(flow_net):
    """The bridge builds the 11-channel net from cnv1's kernel, and the 6-channel one as
    before."""
    tree, _ = flow_net
    model = depth_pose_from_variables(tree, device="cpu")
    assert model.cnv1.conv.weight.shape[1] == 11 and not model.full_resolution
    six = state_dict_to_variables(DepthPoseNet().state_dict())
    assert depth_pose_from_variables(six, device="cpu").cnv1.conv.weight.shape[1] == 6


def test_flow_bf16_serving_error_is_within_limits_the_reference_meets():
    """``chip_smoke.py`` phase 43's net (a seeded 11-channel DepthPoseNet, its statistics
    warmed on the inputs) and inputs at 192x256, B=16: the bf16 folded forward against
    the f32 module forward in both packages, each within TOL_FLOW_SERVING, the port's
    mean error no larger than JAX's, and JAX's own beyond phase 5's 2.5e-2 max and 5e-3
    mean, which is why the flow limit is another."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from tf_depth_estimation_tpu.infer import FlowAugmentedPredictor as JFlow
    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet

    (h, w), n = chip_smoke.FLOW_HW, chip_smoke.FLOW_BATCH
    inputs = chip_smoke.flow_inputs(n, (h, w))
    x = torch.from_numpy(inputs)
    tree = chip_smoke.warmed_variables(
        DepthPoseNet(in_channels=11, generator=torch.Generator().manual_seed(
            chip_smoke.SEED)), x.permute(0, 3, 1, 2))
    with torch.no_grad():
        ref = depth_pose_from_variables(tree, device="cpu").forward_nhwc(x)[0][0][..., 0]
    jref = jax.jit(lambda t, a: JDepthPoseNet().apply(t, a, train=False)[0][0][..., 0])(
        jax.tree.map(jnp.asarray, tree), inputs)
    got = FlowAugmentedPredictor(tree["params"], tree["batch_stats"], height=h, width=w,
                                 batch_size=n, device="cpu").predict(inputs)
    jgot = JFlow(tree["params"], tree["batch_stats"], height=h, width=w,
                 batch_size=n).predict(inputs)
    diffs = {"port": np.abs(got - ref.numpy()), "jax": np.abs(jgot - np.asarray(jref))}
    errs = {k: (float(d.max()), float(d.mean())) for k, d in diffs.items()}
    for worst, mean in errs.values():
        assert worst <= chip_smoke.TOL_FLOW_SERVING[0], errs
        assert mean <= chip_smoke.TOL_FLOW_SERVING[1], errs
    assert errs["port"][1] <= errs["jax"][1], errs
    assert errs["jax"][0] > chip_smoke.TOL_SERVING[0], errs
    assert errs["jax"][1] > chip_smoke.TOL_SERVING[1], errs
