"""split_training in the port against the JAX package: DepthPoseNet's forwards from a flax
init, the explainability terms, ``pairwise_depth_loss`` (both modes) and
``single_depth_loss`` in value and gradient, one float32 step of each phase from a JAX
init, the DeMoN dataset and stream, and the CLI's two phases with both checkpoint groups.
The ``cuda`` tests count the sig kernel's launches in each phase's step on the card.

JAX is imported inside the tests and fixtures that use it: the GPU machine has no JAX,
and runs the ``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.data.demon import DemonDataset, DemonReaderParams, preprocess
from tf_depth_estimation_torch.data.pipeline import StreamLoader
from tf_depth_estimation_torch.data.synthetic import demon_record, write_demon_h5
from tf_depth_estimation_torch.losses import basic, pipelines
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models import DepthPoseNet, DispNet, DispNetVariant
from tf_depth_estimation_torch.ops.schedules import exponential_decay
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_fused
from tf_depth_estimation_torch.train.experiments import split_training
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_pairwise_step, make_single_depth_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz
from tf_depth_estimation_torch.weights import (
    depth_pose_from_variables,
    dispnet_from_variables,
    state_dict_to_variables,
)

H, W, B, LR = 32, 64, 2, 2e-4
STEP = 1000   # the sig weight ramps from 0 at step 0; at 1000 it is ~10
# float32 forwards: the same products summed in another order (tests/test_fast_infer.py)
TOL_FWD = dict(rtol=2e-4, atol=2e-4)
# the losses: sums over the pyramid in another order, photometric and consistency terms
# sampled at coordinates that agree to ~1e-5 (tests/test_torch_losses.py)
TOL_LOSS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The file runs beside other pytest workers: with PyTorch's default of a thread per
    core its CLI test took 124 s there against 10 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(**kw):
    return dataclasses.replace(LossWeights.split_training(), height=H, width=W, **kw)


def _demon_batch(seed=0, batch=B):
    """A preprocessed DeMoN batch of synthetic scenes, numpy."""
    rng = np.random.RandomState(seed)
    params = DemonReaderParams(scaled_height=H, scaled_width=W)
    samples = [preprocess(params, *demon_record(rng, H, W)) for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ---- DepthPoseNet ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["truncated", "full"])
def depth_pose(request):
    """(flax module, its init variables as numpy, an input pair [B, H, W, 6])."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet

    x = _demon_batch(1)["image_pair"]
    module = JDepthPoseNet(full_resolution=request.param)
    init = jax.jit(lambda r: module.init(r, jnp.asarray(x), train=True))(
        jax.random.PRNGKey(0))
    return module, jax.tree.map(np.asarray, dict(init)), x


def _nhwc(ts):
    return [t.permute(0, 2, 3, 1).detach().numpy() for t in ts]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_depth_pose_forward_matches_jax(depth_pose, train):
    """Disparities, pose and mask logits of the eval forward (running statistics) and of
    the train forward (batch statistics, and the running statistics it leaves), from a
    flax init carried through the weight bridge."""
    import jax
    import jax.numpy as jnp

    module, variables, x = depth_pose
    model = depth_pose_from_variables(variables, device="cpu")
    assert model.full_resolution == module.full_resolution
    model.train(train)
    disps, pose, masks = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    if train:   # jitted: op by op, JAX's forward alone takes seconds on the CPU
        ref, mutated = jax.jit(lambda v, a: module.apply(v, a, train=True, mutable=[
            "batch_stats"]))(variables, jnp.asarray(x))
    else:
        ref = jax.jit(lambda v, a: module.apply(v, a, train=False))(variables,
                                                                    jnp.asarray(x))
    # in train mode cnv6b..cnv7b see B * 1 * 1 = 2 values per channel at 32x64, and the
    # batch norm divides their difference by its own size: the float32 rounding of the
    # convolutions' sums (~1e-6 relative) reaches the heads as up to ~4e-4
    tol = dict(rtol=1e-3, atol=1e-3) if train else TOL_FWD
    for got, want in zip(_nhwc(disps) + [pose.detach().numpy()] + _nhwc(masks),
                         list(ref[0]) + [ref[1]] + list(ref[2])):
        np.testing.assert_allclose(got, np.asarray(want), **tol)
    if train:
        got = _flatten(state_dict_to_variables(model.state_dict())["batch_stats"])
        want = {k: np.asarray(v) for k, v in _leaves(mutated["batch_stats"])}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested mapping, paths joined by '/' as ``_flatten`` joins them."""
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_weight_bridge_round_trips_depth_pose(depth_pose):
    """Both ways, bit for bit."""
    _, variables, _ = depth_pose
    back = _flatten(state_dict_to_variables(
        depth_pose_from_variables(variables, device="cpu").state_dict()))
    want = _flatten(variables)
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_weight_bridge_reads_a_4_channel_dispnet():
    """DispNet's input channels come from cnv1's kernel; its eval forward as JAX's."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant

    x = np.random.RandomState(2).uniform(0, 1, (1, H, W, 4)).astype(np.float32)
    j = JDispNet(JVariant.depth4())
    v = jax.tree.map(np.asarray, dict(jax.jit(lambda r: j.init(r, jnp.asarray(x),
                                                                train=False))(
        jax.random.PRNGKey(1))))
    model = dispnet_from_variables(v, device="cpu")
    assert model.encoder["cnv1"].conv.weight.shape[1] == 4
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = jax.jit(lambda v, a: j.apply(v, a, train=False))(v, jnp.asarray(x))
    for g, r in zip(_nhwc(got), ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL_FWD)


# ---- losses ----------------------------------------------------------------------------

def test_explain_losses_match_jax():
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import basic as jbasic

    logits = np.random.RandomState(3).randn(2, 8, 16, 2).astype(np.float32) * 3
    for s in range(4):
        ref_mask = basic.reference_explain_mask(2, 64, 128, s)
        np.testing.assert_array_equal(ref_mask.numpy(),
                                      np.asarray(jbasic.reference_explain_mask(2, 64, 128, s)))
    m = basic.reference_explain_mask(2, 32, 64, 2)
    np.testing.assert_allclose(
        basic.explain_reg_loss(torch.from_numpy(logits), m).item(),
        float(jbasic.explain_reg_loss(jnp.asarray(logits), jnp.asarray(m.numpy()))),
        rtol=1e-6)


def _pair_inputs(full_scales: bool, seed=4):
    """The pairwise loss's arguments (numpy): batch fields and predictions near the
    label at the scales each mode reads."""
    rng = np.random.RandomState(seed)
    batch = _demon_batch(seed)
    scales = range(4) if full_scales else range(2, 4)
    label = batch["depth0"] if full_scales else batch["depth2"]
    f = lambda *shape: rng.uniform(*shape).astype(np.float32)

    def depths():
        return [np.clip(label[:, ::2**(s - (0 if full_scales else 2)),
                              ::2**(s - (0 if full_scales else 2))]
                        * f(0.7, 1.3, (B, H >> s, W >> s, 1)), 0.1, 4.0) for s in scales]

    preds = {"d_l": depths(), "pose_r": f(-0.05, 0.05, (B, 1, 6)),
             "exp_l": [rng.randn(B, H >> s, W >> s, 2).astype(np.float32) for s in scales],
             "d_r": depths(), "pose_l": f(-0.05, 0.05, (B, 1, 6)),
             "exp_r": [rng.randn(B, H >> s, W >> s, 2).astype(np.float32) for s in scales]}
    gt_cam = np.concatenate([batch["translation"], batch["rotation"]], -1)
    return batch, preds, gt_cam, label


PRED_KEYS = ("d_l", "pose_r", "exp_l", "d_r", "pose_l", "exp_r")


@pytest.mark.parametrize("full_scales", [False, True], ids=["default", "full_scales"])
def test_pairwise_depth_loss_matches_jax(full_scales):
    """Every component, and the gradient of the total with respect to each prediction,
    against the JAX package at a step where the sig weight is ~10."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines
    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights

    batch, preds, gt_cam, label = _pair_inputs(full_scales)
    pair = batch["image_pair"]
    jw = dataclasses.replace(JLossWeights.split_training(), height=H, width=W)

    def jloss(p):
        return jpipelines.pairwise_depth_loss(
            pair[..., :3], pair[..., 3:], *(p[k] for k in PRED_KEYS), gt_cam,
            batch["intrinsics"], label, STEP, jw, full_scales=full_scales)

    (jtotal, jcomps), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, preds))
    leaves = {k: ([torch.from_numpy(a).requires_grad_(True) for a in v]
                  if isinstance(v, list) else torch.from_numpy(v).requires_grad_(True))
              for k, v in preds.items()}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    total, comps = pipelines.pairwise_depth_loss(
        t(pair[..., :3]), t(pair[..., 3:]), *(leaves[k] for k in PRED_KEYS), t(gt_cam),
        t(batch["intrinsics"]), t(label), STEP, _weights(), full_scales=full_scales)
    assert sorted(comps) == sorted(jcomps)
    assert float(jcomps["sig"]) > 0 and float(jcomps["consist"]) > 0
    for k, v in jcomps.items():
        np.testing.assert_allclose(float(comps[k]), float(v), **TOL_LOSS, err_msg=k)
    total.backward()
    for k in PRED_KEYS:
        got = leaves[k] if isinstance(leaves[k], list) else [leaves[k]]
        want = jgrads[k] if isinstance(jgrads[k], list) else [jgrads[k]]
        for g, r in zip(got, want):
            scale = np.abs(np.asarray(r)).max()
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=k)


def test_single_depth_loss_matches_jax():
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines
    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights

    rng = np.random.RandomState(5)
    label = _demon_batch(5)["depth0"]
    preds = [np.clip(label[:, ::2**s, ::2**s] * rng.uniform(0.7, 1.3, (B, H >> s, W >> s, 1)),
                     0.1, 4).astype(np.float32) for s in range(4)]
    jw = dataclasses.replace(JLossWeights.split_training(), height=H, width=W)
    (_, jcomps), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpipelines.single_depth_loss(p, label, STEP, jw), has_aux=True))(
        [jnp.asarray(p) for p in preds])
    leaves = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    total, comps = pipelines.single_depth_loss(leaves, torch.from_numpy(label), STEP,
                                               _weights())
    assert sorted(comps) == sorted(jcomps) and float(jcomps["sig"]) > 0
    for k, v in jcomps.items():
        np.testing.assert_allclose(float(comps[k]), float(v), **TOL_LOSS, err_msg=k)
    total.backward()
    for g, r in zip(leaves, jgrads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(r)).max())


# ---- one step of each phase from a JAX init ---------------------------------------------

@pytest.fixture(scope="module")
def steps_from_jax_init():
    """One float32 step of each phase through each package from one JAX
    ``create_train_state`` init, both at step STEP (the optimizer's first update)."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.ops.schedules import exponential_decay as jdecay
    from tf_depth_estimation_tpu.train.state import adam as jadam
    from tf_depth_estimation_tpu.train.state import create_train_state as jcreate
    from tf_depth_estimation_tpu.train.steps import make_pairwise_step as jpair
    from tf_depth_estimation_tpu.train.steps import make_single_depth_step as jsingle

    jw = dataclasses.replace(JLossWeights.split_training(), height=H, width=W)
    pair_batch = _demon_batch(6)
    rng = np.random.RandomState(7)
    single_batch = {"input": np.concatenate(
        [rng.uniform(0.2, 4, (B, H, W, 1)).astype(np.float32),
         pair_batch["image_pair"][..., :3]], -1), "label": pair_batch["depth0"]}
    runs = {
        "pair": (jcreate(JDepthPoseNet(), jnp.zeros((B, H, W, 6)),
                         tx=jadam(jdecay(LR, 10000, 0.96))), jpair(jw), pair_batch,
                 lambda: create_train_state(DepthPoseNet(), lr_schedule=exponential_decay(
                     LR, 10000, 0.96)), make_pairwise_step(_weights())),
        "single": (jcreate(JDispNet(JVariant.depth4()), jnp.zeros((B, H, W, 4)),
                           learning_rate=LR), jsingle(jw), single_batch,
                   lambda: create_train_state(DispNet(DispNetVariant.depth4(),
                                                      in_channels=4), learning_rate=LR),
                   make_single_depth_step(_weights())),
    }
    out = {}
    for phase, (jstate, jstep, batch, port_state, port_step) in runs.items():
        init = jax.tree.map(np.asarray, {"params": jstate.params,
                                         "batch_stats": jstate.batch_stats})
        new, metrics = jax.jit(jstep)(jstate.replace(step=jnp.asarray(STEP, jnp.int32)),
                                      jax.tree.map(jnp.asarray, batch))
        ref = {"metrics": {k: float(v) for k, v in metrics.items()},
               "params": _flatten(jax.tree.map(np.asarray, new.params)),
               "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
        state = port_state()
        state.load_variables(init)
        state.step = STEP
        state, metrics = port_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        variables = state.variables()
        got = {"metrics": {k: float(v) for k, v in metrics.items()},
               "params": _flatten(variables["params"]),
               "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}
        out[phase] = (got, ref, _flatten(init["params"]))
    return out


@pytest.mark.parametrize("phase", ["pair", "single"])
def test_one_step_loss_components_match_jax(steps_from_jax_init, phase):
    got, ref, _ = steps_from_jax_init[phase]
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == STEP + 1
    assert ref["metrics"]["sig"] > 0
    for k, v in ref["metrics"].items():   # the same forward, sums in another order
        # the sig term divides neighbour differences of the prediction by their sum, and a
        # random init's depths are nearly flat (4 sigmoid(~0)): the forwards' float32
        # rounding (~1e-6) reaches it as ~1e-5 (1.1e-5 in phase 2 on the CPU)
        np.testing.assert_allclose(got["metrics"][k], v, rtol=5e-5 if k == "sig" else 1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("phase", ["pair", "single"])
def test_one_step_batch_stats_match_jax(steps_from_jax_init, phase):
    """Running statistics after the train forwards (two in phase 1, the second's win)."""
    got, ref, _ = steps_from_jax_init[phase]
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("phase", ["pair", "single"])
def test_one_step_params_match_jax(steps_from_jax_init, phase):
    """As tests/test_torch_train.py holds config 4: every parameter within 2 lr of JAX's
    after Adam's first update, all but 1 % within 1e-6."""
    got, ref, init = steps_from_jax_init[phase]
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


# ---- DeMoN data and the CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def demon_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demon")
    write_demon_h5(os.path.join(str(root), "scenes.h5"), num_scenes=4, H=H, W=W)
    return str(root)


@pytest.mark.parametrize("scaled", [(H, W), (H // 2, W // 2)], ids=["stored", "resized"])
def test_demon_dataset_matches_jax(demon_dir, scaled):
    """Items (augmented by their index's generator) and scene-pool draws, at the stored
    size and resized, and the first batches of a one-worker stream."""
    from tf_depth_estimation_tpu.data.demon import DemonDataset as JDemonDataset
    from tf_depth_estimation_tpu.data.demon import DemonReaderParams as JParams
    from tf_depth_estimation_tpu.data.pipeline import StreamLoader as JStreamLoader

    src = [(os.path.join(demon_dir, "scenes.h5"), 1.0)]
    kw = dict(batch_size=2, scaled_height=scaled[0], scaled_width=scaled[1])
    ours, ref = DemonDataset(src, DemonReaderParams(**kw), seed=3), \
        JDemonDataset(src, JParams(**kw), seed=3)
    draws = [(ours[i], ref[i]) for i in range(len(ref))]
    ra, rb = np.random.RandomState(9), np.random.RandomState(9)
    draws += [(ours.sample(ra), ref.sample(rb)) for _ in range(6)]
    sa, sb = iter(StreamLoader(ours, 2, seed=1, num_workers=1)), \
        iter(JStreamLoader(ref, 2, seed=1, num_workers=1))
    draws += [(next(sa), next(sb)) for _ in range(2)]
    for a, b in draws:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
    ours.close()
    ref.close()


def _cli(demon_dir, tmp, *extra):
    return split_training.main([
        "--dataset_dir", demon_dir, "--checkpoint_dir", os.path.join(tmp, "pair"),
        "--checkpoint_dir_single", os.path.join(tmp, "single"), "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--summary_freq", "1",
        "--save_latest_freq", "3", "--dtype", "float32", "--device", "cpu", *extra])


def test_cli_trains_both_phases_and_resumes_phase_2(demon_dir, tmp_path):
    """Both phases for 3 steps, as tests/test_experiments.py runs JAX's; both checkpoint
    groups on disk, read back into DepthPoseNet and a 4-channel DispNet (the bridge is
    held to JAX above) with finite eval forwards; then ``--phase single
    --continue_train_single`` resumes phase 2 at step 3 with the pair net restored."""
    tmp = str(tmp_path)
    pair, single = _cli(demon_dir, tmp, "--max_steps", "3", "--max_steps_single", "3")
    assert pair.step == 3 and single.step == 3
    pv, pmeta = load_variables_npz(os.path.join(tmp, "pair", "model_pairdepth-3.npz"))
    sv, smeta = load_variables_npz(os.path.join(tmp, "single", "model_singledepth-3.npz"))
    assert pmeta["step"] == smeta["step"] == "3"
    x = torch.from_numpy(_demon_batch(8)["image_pair"])
    pair_model = depth_pose_from_variables(pv, device="cpu")
    with torch.no_grad():
        disps, pose, masks = pair_model(x.permute(0, 3, 1, 2))
        inp = next(split_training.single_batches(pair_model, iter([{"image_pair": x,
                                                                   "depth0": x}])))
        depths = dispnet_from_variables(sv, device="cpu")(inp["input"].permute(0, 3, 1, 2))
    assert [tuple(d.shape) for d in disps] == [(B, 1, H // 4, W // 4), (B, 1, H // 8, W // 8)]
    assert inp["input"].shape == (B, H, W, 4) and len(depths) == 4
    assert all(bool(torch.isfinite(t).all()) for t in (*disps, pose, *masks, *depths))

    pair2, resumed = _cli(demon_dir, tmp, "--phase", "single", "--max_steps", "3",
                          "--max_steps_single", "4", "--continue_train_single")
    assert pair2.step == 3 and resumed.step == 4   # the pair net restored, not trained
    assert load_variables_npz(os.path.join(tmp, "single", "model_singledepth-4.npz"))[1][
        "step"] == "4"


@pytest.mark.parametrize("flag", ["--rich_summaries"])
def test_cli_refuses_flags_it_lacks(flag, tmp_path):
    """``--rich_summaries``, refused before it was ported, parses as in JAX: phase 1 then
    writes the pairwise summaries every ``--image_summary_freq`` (500) steps
    (``tests/test_torch_summaries.py`` holds them to JAX's)."""
    args = split_training.parse_args(["--dataset_dir", str(tmp_path), flag])
    assert getattr(args, flag[2:]) is True and args.image_summary_freq == 500


def test_cli_reads_demon_v1_through_demon_loader(tmp_path):
    """``--demon_v1`` is accepted, and the DeMoN stream the CLI reads
    (``common.demon_loader``) then streams classic v1 archives in place: the first batch of
    a v1 archive, at the CLI's size."""
    from tf_depth_estimation_torch.data.demon_v1 import write_demon_v1_h5
    from tf_depth_estimation_torch.train.experiments.common import demon_loader

    write_demon_v1_h5(str(tmp_path / "scenes11_train.h5"), num_scenes=2, H=H, W=W)
    args = split_training.parse_args(["--dataset_dir", str(tmp_path), "--demon_v1",
                                      "--batch_size", "2", "--device", "cpu"])
    assert args.demon_v1
    batch = next(demon_loader(args, H, W))
    assert batch["image_pair"].shape == (2, H, W, 6) and batch["depth0"].shape == (2, H, W, 1)
    assert bool(torch.isfinite(batch["depth0"]).all())


def test_cli_defaults_match_jax():
    """The phase flags and the defaults the JAX CLI sets (batch 1, 600001 + 150001 steps,
    save every 5000, 192x256, both phases, bf16)."""
    import argparse

    from tf_depth_estimation_tpu.train.experiments import split_training as jsplit

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jsplit.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    ref, args = vars(captured["ns"]), vars(split_training.parse_args([]))
    for k in ("batch_size", "max_steps", "max_steps_single", "save_latest_freq",
              "image_height", "image_width", "phase", "checkpoint_dir",
              "checkpoint_dir_single", "continue_train_single", "learning_rate", "beta1",
              "dtype", "summary_freq", "seed"):
        assert args[k] == ref[k], k
    assert args["device"] == "cuda"


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("phase,want", [("pair", (1, 1)), ("single", (1, 1))])
def test_cuda_step_launches_the_sig_kernel(phase, want):
    """One float32 step of each phase on the card: one forward and one backward sig
    launch, for the pairs of scales 2 and 3 in phase 1 and of all four in phase 2; every
    component finite."""
    dev = _cuda()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _demon_batch(9).items()}
    if phase == "pair":
        state = create_train_state(DepthPoseNet(
            generator=torch.Generator().manual_seed(0)).to(dev))
        step = make_pairwise_step(_weights())
    else:
        batch = {"input": torch.cat([batch["depth0"], batch["image_pair"][..., :3]], -1),
                 "label": batch["depth0"]}
        state = create_train_state(DispNet(DispNetVariant.depth4(), in_channels=4,
                                           generator=torch.Generator().manual_seed(0)).to(dev))
        step = make_single_depth_step(_weights())
    sig_l2_fused.launches = sig_l2_fused.backward_launches = 0
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert (sig_l2_fused.launches, sig_l2_fused.backward_launches) == want
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
