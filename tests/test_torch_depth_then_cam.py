"""BASELINE config 3 and the pair family's evaluation and serving in the port, against the
JAX package: the presets, ``depth_then_cam_loss`` in value and gradient, one float32 step
from one init in both packages, the eval harness's two nets, ``fast_depth_pose_forward`` at both
resolutions, ``PairPredictor`` and ``infer/cli.py --mode pair``, and the config-3 CLI on
an HDF5 file. The ``cuda`` tests count the fused sampler's launches in a config-3 step and
hold the folded serving forward to the module on the card.

JAX is imported inside the tests and fixtures that use it: the GPU machine has no JAX,
and runs the ``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import argparse
import dataclasses
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.data.demon import DemonReaderParams, preprocess
from tf_depth_estimation_torch.data.synthetic import demon_record, write_demon_h5
from tf_depth_estimation_torch.geometry.warp import projective_inverse_warp
from tf_depth_estimation_torch.infer import cli
from tf_depth_estimation_torch.infer.fast_pose import fast_depth_pose_forward
from tf_depth_estimation_torch.infer.predictor import PairPredictor
from tf_depth_estimation_torch.losses import pipelines
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models import DepthPoseNet, DispNet, DispNetVariant
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.ops.bilinear_sample_fused import bilinear_sample_fused
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused
from tf_depth_estimation_torch.train.experiments import depth_then_cam, eval_harness
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_then_cam_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import (depth_pose_from_variables,
                                               dispnet_from_variables, state_dict_to_variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B, LR = 32, 64, 2, 2e-4
# float32 forwards: the same products summed in another order (tests/test_fast_infer.py:37)
TOL_FWD = dict(rtol=2e-4, atol=2e-4)
# the losses: sums over the pyramid in another order, photometric terms sampled at
# coordinates that agree to ~1e-5 (tests/test_torch_losses.py)
TOL_LOSS = dict(rtol=1e-5, atol=1e-5)
# the layers the full-resolution DepthPoseNet has beyond the truncated one
FULL_ONLY = ("exp_upcnv2", "mask2", "exp_upcnv1", "mask1", "upcnv2", "icnv2", "disp2",
             "upcnv1", "icnv1", "disp1")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The file runs beside other pytest workers (tests/test_torch_split.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _demon_batch(seed=0, batch=B):
    """A preprocessed DeMoN batch of synthetic scenes, numpy."""
    rng = np.random.RandomState(seed)
    params = DemonReaderParams(scaled_height=H, scaled_width=W)
    samples = [preprocess(params, *demon_record(rng, H, W)) for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---- presets ---------------------------------------------------------------------------

def test_presets_are_jaxs_but_config_3s_sampler():
    """Every preset of the port equals the JAX package's, field by field, except five
    ``sampler`` fields where JAX keeps "xla": ``depth_then_cam()``'s "fused", and
    "pallas" in the L/R family's ``depth_then_cam_lr()`` and ``gtdepth_gtcam()`` and the
    colon-pair family's ``dim11()`` and ``only_image()``."""
    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights

    names = [k for k, v in vars(JLossWeights).items() if isinstance(v, classmethod)]
    assert len(names) >= 12 and "depth_then_cam" in names
    diffs = {}
    for name in names:
        ours = dataclasses.asdict(getattr(LossWeights, name)())
        ref = dataclasses.asdict(getattr(JLossWeights, name)())
        assert sorted(ours) == sorted(ref), name
        diffs.update({(name, k): (ours[k], ref[k]) for k in ref if ours[k] != ref[k]})
    assert diffs == {("depth_then_cam", "sampler"): ("fused", "xla"),
                     ("depth_then_cam_lr", "sampler"): ("pallas", "xla"),
                     ("gtdepth_gtcam", "sampler"): ("pallas", "xla"),
                     ("dim11", "sampler"): ("pallas", "xla"),
                     ("only_image", "sampler"): ("pallas", "xla")}


# ---- the loss --------------------------------------------------------------------------

def _loss_inputs(seed=3, off_grid: bool = True):
    """Batch fields and predictions of the full-resolution net: disparities in (0, 4],
    small Euler poses, explainability logits. ``off_grid`` moves each image value by up
    to half a uint8 step: the synthetic scenes' images are uint8 values with flat patches,
    so a warp can land exactly on the left image's value, an error of exactly 0, where
    |t| has no derivative and the two packages' rounding decides its sign."""
    rng = np.random.RandomState(seed)
    batch = _demon_batch(seed)
    if off_grid:
        batch["image_pair"] = (batch["image_pair"] + rng.uniform(
            -0.5, 0.5, batch["image_pair"].shape) / 255).astype(np.float32)
    preds = {"disps": [rng.uniform(0.3, 3.5, (B, H >> s, W >> s, 1)).astype(np.float32)
                       for s in range(4)],
             "poses": rng.uniform(-0.05, 0.05, (B, 1, 6)).astype(np.float32),
             "exps": [rng.randn(B, H >> s, W >> s, 2).astype(np.float32) for s in range(4)]}
    return batch, preds


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    """JAX's ``depth_then_cam_loss`` and its gradient in the predictions, jitted once."""
    import jax

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines
    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights

    jw = dataclasses.replace(JLossWeights.depth_then_cam(), height=H, width=W)
    return jax.jit(jax.value_and_grad(lambda p, pair, intr: jpipelines.depth_then_cam_loss(
        pair[..., :3], pair[..., 3:], p["disps"], p["poses"], p["exps"], intr, jw),
        has_aux=True))


def _jax_loss_and_grads(batch, preds):
    """JAX's components and gradients of ``depth_then_cam_loss``."""
    import jax
    import jax.numpy as jnp

    (_, jcomps), jgrads = _jax_value_and_grad()(
        jax.tree.map(jnp.asarray, preds), jnp.asarray(batch["image_pair"]),
        jnp.asarray(batch["intrinsics"]))
    return {k: float(v) for k, v in jcomps.items()}, jax.tree.map(np.asarray, jgrads)


def _port_loss_and_grads(batch, preds):
    """The port's components, gradients and photometric errors (the fused sampler, its
    plain version on the CPU)."""
    leaves = {k: ([torch.from_numpy(a).requires_grad_(True) for a in v]
                  if isinstance(v, list) else torch.from_numpy(v).requires_grad_(True))
              for k, v in preds.items()}
    w = dataclasses.replace(LossWeights.depth_then_cam(), height=H, width=W)
    assert w.sampler == "fused"
    tb = _t(batch)
    total, comps = pipelines.depth_then_cam_loss(
        tb["image_pair"][..., :3], tb["image_pair"][..., 3:], leaves["disps"],
        leaves["poses"], leaves["exps"], tb["intrinsics"], w)
    total.backward()
    grads = {k: [g.grad.numpy() for g in v] if isinstance(v, list) else v.grad.numpy()
             for k, v in leaves.items()}
    return {k: float(v.detach()) for k, v in comps.items()}, grads


def test_depth_then_cam_loss_matches_jax():
    """Every component, and the gradient of the total with respect to each prediction,
    on images off the uint8 grid (``_loss_inputs``)."""
    batch, preds = _loss_inputs()
    jcomps, jgrads = _jax_loss_and_grads(batch, preds)
    comps, grads = _port_loss_and_grads(batch, preds)
    assert sorted(comps) == sorted(jcomps) and all(v > 0 for v in jcomps.values())
    for k, v in jcomps.items():
        np.testing.assert_allclose(comps[k], v, **TOL_LOSS, err_msg=k)
    for k in preds:
        got = grads[k] if isinstance(grads[k], list) else [grads[k]]
        want = jgrads[k] if isinstance(jgrads[k], list) else [jgrads[k]]
        for g, r in zip(got, want):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * np.abs(r).max(),
                                       err_msg=k)


def test_loss_gradient_differs_from_jaxs_only_at_photometric_ties():
    """On the uint8 images themselves the disparity gradients differ at a few pixels, and
    only at pixels whose photometric error is 0 in some channel (to 1e-6): there the
    derivative of |t| is JAX's +1 (at 0, or at the sign its rounding gives) against
    PyTorch's 0 (ROADMAP, known deviations)."""
    batch, preds = _loss_inputs(off_grid=False)
    _, jgrads = _jax_loss_and_grads(batch, preds)
    _, grads = _port_loss_and_grads(batch, preds)
    tb = _t(batch)
    moved = 0
    for s in range(4):
        g, r = grads["disps"][s], jgrads["disps"][s]
        off = (np.abs(g - r) > 1e-4 * np.abs(r) + 1e-5 * np.abs(r).max())[..., 0]
        hw = (H >> s, W >> s)
        err = projective_inverse_warp(
            pipelines._area(tb["image_pair"][..., 3:], hw),
            1.0 / torch.from_numpy(preds["disps"][s][..., 0]),
            torch.from_numpy(preds["poses"][:, 0]), tb["intrinsics"][:, s],
            fmt="euler").image - pipelines._area(tb["image_pair"][..., :3], hw)
        ties = (err.abs() <= 1e-6).any(-1).numpy()
        assert not (off & ~ties).any(), s
        moved += int(off.sum())
    assert moved > 0


# ---- one step from one init in both packages -------------------------------------------

@pytest.fixture(scope="module")
def jax_full():
    """(JAX train state of the full-resolution DepthPoseNet, its init as numpy), the file's
    one init of the net: a seeded init of the port's module carried into JAX's variables
    tree, and JAX's ``create_train_state`` around it (Adam at LR, step 0). JAX's own
    jitted init would compile the net's random init, ~8 s of XLA on the CPU, for weights
    that any seeded values serve as well."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet
    from tf_depth_estimation_tpu.train.state import TrainState, adam

    init = state_dict_to_variables(DepthPoseNet(
        full_resolution=True, generator=torch.Generator().manual_seed(0)).state_dict())
    params = jax.tree.map(jnp.asarray, init["params"])
    tx = adam(LR)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, init["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=JDepthPoseNet(full_resolution=True).apply)
    return jstate, init


@pytest.fixture(scope="module")
def step_from_one_init(jax_full):
    """One float32 config-3 step through each package from the same init and batch."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.train.steps import make_depth_then_cam_step as jstep

    jstate, init = jax_full
    batch = _demon_batch(4)
    jw = dataclasses.replace(JLossWeights.depth_then_cam(), height=H, width=W)
    new, metrics = jax.jit(jstep(jw))(jstate, jax.tree.map(jnp.asarray, batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
    state = create_train_state(DepthPoseNet(full_resolution=True), learning_rate=LR)
    state.load_variables(init)
    w = dataclasses.replace(LossWeights.depth_then_cam(), height=H, width=W)
    state, metrics = make_depth_then_cam_step(w)(state, _t(batch))
    variables = state.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}
    return got, ref, _flatten(init["params"])


def test_one_step_loss_components_match_jax(step_from_one_init):
    got, ref, _ = step_from_one_init
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == 1
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_one_step_batch_stats_match_jax(step_from_one_init):
    """Running statistics after the train forward, at tests/test_torch_split.py's
    tolerance for DepthPoseNet."""
    got, ref, _ = step_from_one_init
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(step_from_one_init):
    """Every parameter within 2 lr of JAX's after Adam's first update, all but 1 % within
    1e-6 (tests/test_torch_split.py, tests/test_torch_train.py)."""
    got, ref, init = step_from_one_init
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


# ---- serving weights -------------------------------------------------------------------

def _served(init, full: bool, seed=5):
    """``init`` with its batch statistics moved off 0 / 1 (seeded; as a trained checkpoint
    carries them), and for ``full=False`` without the full-resolution layers: the
    truncated net's tree."""
    rng = np.random.RandomState(seed)

    def walk(node, path=()):
        if not isinstance(node, dict):
            if path[-1] == "mean":
                return (node + rng.uniform(-0.2, 0.2, node.shape)).astype(np.float32)
            if path[-1] == "var":
                return (node * rng.uniform(0.5, 1.5, node.shape)).astype(np.float32)
            return node
        return {k: walk(v, path + (k,)) for k, v in node.items()
                if full or k not in FULL_ONLY}

    return walk(init)


# ---- the eval harness ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_apply(full: bool):
    """JAX DepthPoseNet's eval forward, jitted once for the file (JAX compiles each
    function once per shape)."""
    import jax

    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet

    return jax.jit(functools.partial(JDepthPoseNet(full_resolution=full).apply,
                                     train=False))


@pytest.fixture(scope="module")
def eval_nets(jax_full):
    """(pair variables, single variables, JAX's eval_batch for each net): the bodies of
    JAX ``experiments/eval_harness.py:59-85`` at float32, each net's forward and each
    loss jitted on its own."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines
    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.ops.resize import resize_nearest

    pv = _served(jax_full[1], full=True)
    single = JDispNet(JVariant.depth4())
    # a seeded init of the port's 4-channel depth4 DispNet, as jax_full's
    sv = state_dict_to_variables(DispNet(DispNetVariant.depth4(), in_channels=4,
                                         generator=torch.Generator().manual_seed(2))
                                 .state_dict())
    pair = lambda x: _jax_apply(True)(pv, x)
    jw = dataclasses.replace(JLossWeights.split_training(), height=H, width=W)
    pair_loss = jax.jit(lambda *a: jpipelines.pairwise_depth_loss(
        *a, jw.max_steps, jw, full_scales=True)[1])
    single_loss = jax.jit(lambda p, d: jpipelines.single_depth_loss(p, d, jw.max_steps,
                                                                    jw)[1])

    def eval_pair(batch):
        img = batch["image_pair"]
        left, right = img[..., :3], img[..., 3:]
        d_l, pose_r, exp_l = pair(img)
        d_r, pose_l, exp_r = pair(jnp.concatenate([right, left], -1))
        gt_cam = jnp.concatenate([batch["translation"], batch["rotation"]], axis=-1)
        return pair_loss(left, right, d_l, pose_r, exp_l, d_r, pose_l, exp_r, gt_cam,
                         batch["intrinsics"], batch["depth0"])

    def eval_single(batch):
        img = batch["image_pair"]
        disps, _pose, _m = pair(img)
        coarse = resize_nearest(disps[0], (H, W))
        preds = jax.jit(single.apply, static_argnames="train")(
            sv, jnp.concatenate([coarse, img[..., :3]], -1), train=False)
        return single_loss(preds, batch["depth0"])

    return pv, sv, {"pair": eval_pair, "single": eval_single}


@pytest.mark.parametrize("net", ["pair", "single"])
def test_eval_harness_matches_jax(eval_nets, net):
    """The port's eval function of each net against JAX's eval_batch on one batch; the
    sig terms go through ``sig_l2_fused`` (its plain version on the CPU), and the sig
    weight is fully ramped (the preset's last step), as in JAX."""
    import jax
    import jax.numpy as jnp

    pv, sv, jfns = eval_nets
    batch = _demon_batch(6)
    ref = {k: float(v) for k, v in jfns[net](jax.tree.map(jnp.asarray, batch)).items()}
    w = dataclasses.replace(LossWeights.split_training(), height=H, width=W)
    fn = eval_harness.make_eval_fn(
        w, depth_pose_from_variables(pv, device="cpu"),
        dispnet_from_variables(sv, device="cpu") if net == "single" else None)
    got = {k: float(v) for k, v in fn(_t(batch)).items()}
    assert sorted(got) == sorted(ref) and ref["sig"] > 0
    for k, v in ref.items():
        # the sig term divides neighbour differences of nearly flat random-init depths
        # by their sum (tests/test_torch_split.py's 5e-5)
        np.testing.assert_allclose(got[k], v, rtol=5e-5 if k == "sig" else 1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def demon_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demon")
    write_demon_h5(os.path.join(str(root), "scenes.h5"), num_scenes=4, H=H, W=W)
    return str(root)


def test_eval_harness_cli_restores_both_groups(eval_nets, demon_dir, tmp_path):
    """``main`` on an HDF5 file: the pair net from ``model_pairdepth``, the single net from
    ``model_singledepth``, the DeMoN stream in test order: asked for one batch, its means
    are the eval function's on items 0-1, the first batch (the test phase reads with one
    worker, ROADMAP Queue 3 #4); a truncated pair checkpoint is reported and the seeded
    init kept, as JAX's harness does."""
    from tf_depth_estimation_torch.data.demon import DemonDataset
    from tf_depth_estimation_torch.data.pipeline import BatchLoader
    from tf_depth_estimation_torch.train.experiments.common import demon_sources

    pv, sv, _ = eval_nets
    pair_dir, single_dir = str(tmp_path / "pair"), str(tmp_path / "single")
    os.makedirs(pair_dir), os.makedirs(single_dir)
    save_variables_npz(os.path.join(pair_dir, "model_pairdepth-7.npz"), pv)
    save_variables_npz(os.path.join(single_dir, "model_singledepth-3.npz"), sv)
    argv = ["--dataset_dir", demon_dir, "--checkpoint_dir", pair_dir,
            "--checkpoint_dir_single", single_dir, "--net", "single", "--image_height",
            str(H), "--image_width", str(W), "--batch_size", "2", "--eval_batches", "1",
            "--dtype", "float32", "--device", "cpu"]
    means = eval_harness.main(argv)
    args = eval_harness.parse_args(argv)
    ds = DemonDataset(demon_sources(demon_dir), DemonReaderParams(
        batch_size=2, scaled_height=H, scaled_width=W, test_phase=True))
    fn = eval_harness.make_eval_fn(eval_harness.loss_weights(args),
                                   depth_pose_from_variables(pv, device="cpu"),
                                   dispnet_from_variables(sv, device="cpu"))
    first = fn(_t(BatchLoader._collate([ds[0], ds[1]])))
    ds.close()
    assert sorted(means) == sorted(first)
    for k in means:
        np.testing.assert_allclose(means[k], float(first[k]), rtol=1e-6, err_msg=k)

    save_variables_npz(os.path.join(pair_dir, "model_pairdepth-9.npz"), _served(pv, False))
    args = eval_harness.parse_args(argv[:4] + ["--device", "cpu"])
    seeded = DepthPoseNet(full_resolution=True, generator=torch.Generator().manual_seed(0))
    restored = eval_harness.pair_model(args)
    for k, v in seeded.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k


# ---- the folded eval forward -----------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["truncated", "full"])
def pose_refs(request, jax_full):
    """(served variables, input pair, JAX DepthPoseNet.apply eval outputs, JAX
    fast_depth_pose_forward outputs) at 32x64, B=2."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.infer.fast_pose import fast_depth_pose_forward as jfast

    full = request.param
    variables = _served(jax_full[1], full)
    x = np.random.RandomState(7).rand(B, H, W, 6).astype(np.float32)
    module = _jax_apply(full)(variables, jnp.asarray(x))
    fast = jax.jit(functools.partial(jfast, full_resolution=full, dtype=jnp.float32))(
        variables, jnp.asarray(x))
    flat = lambda outs: [np.asarray(a) for a in jax.tree.leaves(outs)]
    return full, variables, x, flat(module), flat(fast)


def _leaves(outs):
    disps, pose, masks = outs
    return [t.detach().numpy() for t in (*disps, pose, *masks)]


@pytest.mark.parametrize("ref", ["module", "fast"])
def test_fast_pose_forward_matches_jax(pose_refs, ref):
    """Disparities, pose and masks of the folded forward against JAX's module forward and
    JAX's folded forward, at tests/test_fast_infer.py:37's tolerance."""
    full, variables, x, module_ref, fast_ref = pose_refs
    got = _leaves(fast_depth_pose_forward(variables, x, full_resolution=full,
                                          dtype=torch.float32, device="cpu"))
    want = module_ref if ref == "module" else fast_ref
    assert len(got) == len(want) == (9 if full else 5)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **TOL_FWD)


def test_fast_pose_forward_matches_the_port_module(pose_refs):
    full, variables, x, _, _ = pose_refs
    model = depth_pose_from_variables(variables, device="cpu")
    with torch.no_grad():
        disps, pose, masks = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = [t.permute(0, 2, 3, 1).numpy() for t in disps] + [pose.numpy()] + \
        [t.permute(0, 2, 3, 1).numpy() for t in masks]
    got = _leaves(fast_depth_pose_forward(model, x, full_resolution=full,
                                          dtype=torch.float32, device="cpu"))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, **TOL_FWD)


def test_fast_pose_forward_refuses_sizes_not_divisible_by_4():
    model = DepthPoseNet()
    with pytest.raises(ValueError, match="divisible by 4"):
        fast_depth_pose_forward(model, torch.zeros(1, 30, 64, 6), dtype=torch.float32,
                                device="cpu")


@pytest.mark.parametrize("use_fast,stats,hw,want", [
    (None, True, (32, 64), True), (None, False, (32, 64), False),
    (None, True, (30, 64), False), (False, True, (32, 64), False),
    (True, False, (32, 64), ValueError), (True, True, (32, 66), ValueError)])
def test_pair_predictor_takes_the_folded_forward_where_jax_does(use_fast, stats, hw, want):
    """JAX's ``_resolve_use_fast`` (``infer/predictor.py:112-123``): the folded forward
    needs batch statistics and H, W divisible by 4."""
    from tf_depth_estimation_tpu.infer.predictor import _resolve_use_fast as jresolve

    from tf_depth_estimation_torch.infer.predictor import _resolve_use_fast

    stats = {"cnv1": {}} if stats else None
    for resolve in (_resolve_use_fast, jresolve):
        if want is ValueError:
            with pytest.raises(ValueError):
                resolve(use_fast, stats, *hw)
        else:
            assert resolve(use_fast, stats, *hw) is want


# ---- PairPredictor and the pair CLI ----------------------------------------------------

@pytest.fixture(scope="module")
def pair_served(jax_full, tmp_path_factory):
    """5 JPEG frames, the truncated net's served weights as an ``.npz``, and JAX's
    PairPredictor on the frames as read and on their directory (what JAX's CLI in pair
    mode runs after it has read the weights)."""
    import cv2
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.infer.predictor import PairPredictor as JPairPredictor
    from tf_depth_estimation_tpu.infer.predictor import _load_frame

    root = tmp_path_factory.mktemp("pair")
    frames_dir = root / "frames"
    frames_dir.mkdir()
    rng = np.random.RandomState(8)
    base = rng.randint(0, 256, (48, 96, 3))
    for i in range(5):   # a drifting texture, as consecutive frames
        cv2.imwrite(str(frames_dir / f"f{i:03d}.jpg"),
                    np.roll(base, 2 * i, axis=1).astype(np.uint8))
    variables = _served(jax_full[1], full=False)
    npz = str(root / "pair.npz")
    save_variables_npz(npz, variables)
    paths = sorted(glob.glob(str(frames_dir / "*.jpg")))
    frames = np.stack([_load_frame(p, H, W) for p in paths])
    jpred = JPairPredictor(variables["params"], variables["batch_stats"], height=H, width=W,
                           batch_size=2, dtype=jnp.float32)
    ref_z, ref_pose = jpred.predict_pairs(frames)
    argv = ["--dataset_dir", str(frames_dir), "--weights", npz, "--mode", "pair",
            "--image_height", str(H), "--image_width", str(W), "--batch_size", "2",
            "--out_height", "20", "--out_width", "30", "--dtype", "float32"]
    jpred.predict_directory(str(frames_dir), str(root / "jax_out"), out_height=20,
                            out_width=30)
    jax_out = {os.path.basename(p): np.fromfile(p, np.float32)
               for p in glob.glob(str(root / "jax_out" / "*_z.bin"))}
    jax_poses = {os.path.basename(p): np.loadtxt(p + ".txt") for p in paths[:-1]}
    return {"variables": variables, "frames": frames, "ref": (ref_z, ref_pose),
            "argv": argv, "root": root, "jax_out": jax_out, "jax_poses": jax_poses,
            "paths": paths, "npz": npz}


@pytest.mark.parametrize("use_fast", [True, False], ids=["folded", "module"])
def test_pair_predictor_matches_jax(pair_served, use_fast):
    """Depth and pose of the 4 consecutive pairs of 5 frames (a full batch of 2 and
    another), through the folded forward and through the module forward."""
    v = pair_served["variables"]
    pred = PairPredictor(v["params"], v["batch_stats"], height=H, width=W, batch_size=2,
                         dtype=torch.float32, use_fast=use_fast, device="cpu")
    assert pred.uses_fast_path == use_fast
    z, pose = pred.predict_pairs(pair_served["frames"])
    ref_z, ref_pose = pair_served["ref"]
    assert z.shape == ref_z.shape == (4, H // 4, W // 4) and pose.shape == (4, 6)
    np.testing.assert_allclose(z, ref_z, **TOL_FWD)
    np.testing.assert_allclose(pose, ref_pose, **TOL_FWD)


def test_pair_cli_matches_jax(pair_served):
    """``--mode pair`` writes what JAX's serving writes: a ``_z.bin`` per pair (depth after the
    cubic upsize and the bilateral filter, both smooth in the depth, so within the
    forward's tolerance) and a ``<frame>.txt`` pose beside each frame but the last
    (printed with 6 decimals, so equal to within a unit of the last)."""
    out = pair_served["root"] / "port_out"
    written = cli.main(pair_served["argv"] + ["--output_dir", str(out), "--device", "cpu"])
    assert len(written) == 4
    got = {os.path.basename(p): np.fromfile(p, np.float32) for p in written}
    assert sorted(got) == sorted(pair_served["jax_out"])
    for k, v in pair_served["jax_out"].items():
        assert v.size == 20 * 30
        np.testing.assert_allclose(got[k], v, **TOL_FWD, err_msg=k)
    for p in pair_served["paths"][:-1]:
        np.testing.assert_allclose(np.loadtxt(p + ".txt"),
                                   pair_served["jax_poses"][os.path.basename(p)],
                                   rtol=0, atol=1.5e-6)


def test_pair_cli_refuses_other_weights(pair_served, jax_full, tmp_path):
    """The tree is checked before serving: full-resolution DepthPoseNet weights, and
    depth4 DispNet weights, are refused with the file named."""
    full = str(tmp_path / "full.npz")
    save_variables_npz(full, jax_full[1])
    teacher = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")
    for npz, what in ((full, "full-resolution"), (teacher, "DepthPoseNet")):
        argv = [a if a != pair_served["npz"] else npz for a in pair_served["argv"]]
        with pytest.raises(SystemExit, match=what):
            cli.main(argv + ["--output_dir", str(tmp_path / "out"), "--device", "cpu"])


# ---- the config-3 CLI ------------------------------------------------------------------

def test_cli_trains_config_3(demon_dir, tmp_path):
    """``depth_then_cam.main`` with ``--device cpu --dtype float32`` for 2 steps on an
    HDF5 file: two finite records and a checkpoint that reads back into the
    full-resolution DepthPoseNet with a finite eval forward."""
    ckpt = str(tmp_path / "ckpt")
    state, _ = depth_then_cam.main([
        "--dataset_dir", demon_dir, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "2",
        "--summary_freq", "1", "--save_latest_freq", "2", "--dtype", "float32",
        "--device", "cpu"])
    assert state.step == 2 and state.model.full_resolution
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records for k in ("total", "pixel", "smooth",
                                                             "exp"))
    variables, meta = load_variables_npz(os.path.join(ckpt, "model-2.npz"))
    model = depth_pose_from_variables(variables, device="cpu")
    with torch.no_grad():
        disps, pose, masks = model(torch.from_numpy(_demon_batch(9)["image_pair"])
                                   .permute(0, 3, 1, 2))
    assert meta["step"] == "2" and model.full_resolution and len(disps) == 4
    assert all(bool(torch.isfinite(t).all()) for t in (*disps, pose, *masks))
    for p in glob.glob(os.path.join(ckpt, "model-*")):   # ~400 MB of weights and Adam
        os.remove(p)


def _jax_cli_namespace(main, argv) -> dict:
    """The namespace a JAX CLI's ``main(argv)`` parses, without running it."""
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return vars(captured["ns"])


@pytest.mark.parametrize("name", ["depth_then_cam", "eval_harness"])
def test_cli_defaults_match_jax(name):
    """Every flag the JAX CLI parses, with its default, and ``--device cuda``."""
    import importlib


    jmod = importlib.import_module(f"tf_depth_estimation_tpu.train.experiments.{name}")
    port = {"depth_then_cam": depth_then_cam, "eval_harness": eval_harness}[name]
    ref, args = _jax_cli_namespace(jmod.main, []), vars(port.parse_args([]))
    for k, v in ref.items():
        assert args[k] == v, k
    assert args["device"] == "cuda"


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_launches_the_fused_sampler():
    """One float32 config-3 step at B=8 (inside the rule): one forward and one backward
    fused sampler launch for the four scales' warps (one group call), one forward and one
    backward smoothness launch for the four scales, no launch on the sampler's own route
    and no plain sampling."""
    dev = _cuda()
    batch = {k: v.to(dev) for k, v in _t(_demon_batch(10, batch=8)).items()}
    state = create_train_state(DepthPoseNet(
        full_resolution=True, generator=torch.Generator().manual_seed(0)).to(dev))
    w = dataclasses.replace(LossWeights.depth_then_cam(), height=H, width=W)
    bilinear_sample_fused.launches = bilinear_sample_fused.backward_launches = 0
    smoothness_fused.launches = smoothness_fused.backward_launches = 0
    bs.bilinear_sample.launches = bs.bilinear_sample_reference.calls = 0
    _, metrics = make_depth_then_cam_step(w)(state, batch)
    torch.cuda.synchronize()
    assert (bilinear_sample_fused.launches, bilinear_sample_fused.backward_launches) == (1, 1)
    assert (smoothness_fused.launches, smoothness_fused.backward_launches) == (1, 1)
    assert bs.bilinear_sample.launches == 0 and bs.bilinear_sample_reference.calls == 0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["truncated", "full"])
def test_cuda_fast_pose_forward_matches_the_module(full):
    """The folded forward in float32 on the card against the module's eval forward, TF32
    off, at tests/test_fast_infer.py:37's tolerance."""
    dev = _cuda()
    model = DepthPoseNet(full_resolution=full, generator=torch.Generator().manual_seed(1))
    model = model.to(dev).eval()
    x = torch.from_numpy(np.random.RandomState(11).rand(4, 64, 96, 6).astype(np.float32))
    with torch.no_grad():
        disps, pose, masks = model(x.to(dev).permute(0, 3, 1, 2))
        got = fast_depth_pose_forward(model, x, full_resolution=full, dtype=torch.float32,
                                      device=dev)
    want = [t.permute(0, 2, 3, 1) for t in disps] + [pose] + \
        [t.permute(0, 2, 3, 1) for t in masks]
    for g, r in zip([*got[0], got[1], *got[2]], want):
        torch.testing.assert_close(g, r, **TOL_FWD)
