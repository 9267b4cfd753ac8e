"""The symmetric L/R family in the port against the JAX package: ``LRNet``'s forward in
both modes from one init carried across by ``lrnet_from_variables``, the weight bridge's
round trip, ``lr_full_loss`` and ``lr_gt_pose_loss`` on shared predictions, one float32
step of ``make_lr_full_step`` and ``make_lr_gt_step`` from one init in both packages, and
the CLI in both modes. The ``cuda`` tests count the kernels' launches in each step on the
card.

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

from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)
from tf_depth_estimation_torch.data.demon import DemonReaderParams, preprocess
from tf_depth_estimation_torch.data.synthetic import demon_record, write_demon_h5
from tf_depth_estimation_torch.losses import pipelines
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models import LRNet
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_fused
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused
from tf_depth_estimation_torch.train.experiments import depth_then_cam_lr
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_lr_full_step, make_lr_gt_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz
from tf_depth_estimation_torch.weights import lrnet_from_variables, state_dict_to_variables

H, W, B, LR = 32, 64, 2, 2e-4
# float32 forwards: the same products summed in another order (tests/test_fast_infer.py:37)
TOL_FWD = dict(rtol=2e-4, atol=2e-4)
MODES = {"full": False, "gt_pose": True}   # mode -> gt_pose
# one step's loss components, port against JAX: rtol 1e-5, but 5e-5 for the terms that
# amplify the two float32 forwards' rounding. At B=2 and 32x64 the deepest layers are
# train-mode batch norms over 2 values (cnv7, pose_cam_cnv7 at 1x1), and the packages'
# forwards give poses up to 1.1e-4 apart (3e-4 relative) and disparities up to 8.5e-4
# (within the forward's 2e-4 + 2e-4 |x|): that moves the cam term by ~3e-5, the
# consistency term by ~1.5e-5 and the second differences of the random init's nearly flat
# 1/disp maps by ~1.1e-5 relative (tests/test_torch_split.py allows its sig term 5e-5 for
# the same reason). On the same predictions the two losses agree within 2e-7
# (test_lr_loss_matches_jax holds them to 1e-5).
TOL_STEP_LOSS = {"cam": 5e-5, "consist": 5e-5, "smooth": 5e-5}


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


def _weights(gt_pose: bool, jax: bool = False):
    if jax:
        from tf_depth_estimation_tpu.losses.config import LossWeights as table
    else:
        table = LossWeights
    base = table.gtdepth_gtcam() if gt_pose else table.depth_then_cam_lr()
    return dataclasses.replace(base, height=H, width=W)


def _pair_only(tree: dict) -> dict:
    """The ``with_single=False`` tree of an LRNet tree: its ``pair`` part."""
    return {k: {"pair": v["pair"]} for k, v in tree.items()}


@pytest.fixture(scope="module")
def init():
    """The file's one init of LRNet, a seeded init of the port's module as a JAX variables
    tree (JAX's own jitted init would compile two nets' random init for weights that any
    seeded values serve as well); mode -> tree."""
    full = state_dict_to_variables(LRNet(
        with_single=True, generator=torch.Generator().manual_seed(0)).state_dict())
    return {"full": full, "gt_pose": _pair_only(full)}


# ---- LRNet -----------------------------------------------------------------------------

def _moved_stats(tree: dict, seed=5) -> dict:
    """``tree`` with its batch statistics moved off 0 / 1 (seeded), as a trained checkpoint
    carries them."""
    rng = np.random.RandomState(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "mean":
            return (node + rng.uniform(-0.2, 0.2, node.shape)).astype(np.float32)
        return (node * rng.uniform(0.5, 1.5, node.shape)).astype(np.float32)

    return {"params": tree["params"], "batch_stats": walk(tree["batch_stats"])}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lrnet_forward_matches_jax(init, mode):
    """The eval forward of ``lrnet_from_variables`` against JAX's LRNet on the same tree,
    every output of the dict, float32."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import LRNet as JLRNet

    variables = _moved_stats(init[mode])
    pair = _demon_batch(1)["image_pair"]
    left, right = pair[..., :3], pair[..., 3:]
    ref = jax.jit(functools.partial(JLRNet(with_single=not MODES[mode]).apply,
                                    train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(left), jnp.asarray(right))
    model = lrnet_from_variables(variables, device="cpu")
    assert model.with_single == (mode == "full") and not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(left)),
                    torch.from_numpy(np.ascontiguousarray(right)))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k] if isinstance(got[k], list) else [got[k]]
        r = r if isinstance(r, list) else [r]
        assert len(g) == len(r), k
        for a, b in zip(g, r):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_FWD, err_msg=k)


def test_weight_bridge_round_trips_lrnet(init):
    """JAX tree -> ``lrnet_from_variables`` -> state dict -> the same tree, both modes."""
    for mode, tree in init.items():
        back = state_dict_to_variables(lrnet_from_variables(tree, device="cpu").state_dict())
        a, b = _flatten(tree), _flatten(back)
        assert sorted(a) == sorted(b), mode
        assert all(np.array_equal(a[k], b[k]) for k in a), mode


# ---- the losses ------------------------------------------------------------------------

def _loss_inputs(seed=3):
    """Batch fields and predictions of LRNet: disparities in (0.3, 3.5), small angle-axis
    poses, explainability logits; the images moved off the uint8 grid by up to half a
    step, so that no photometric error is exactly 0 (tests/test_torch_depth_then_cam.py)."""
    rng = np.random.RandomState(seed)
    batch = _demon_batch(seed)
    batch["image_pair"] = (batch["image_pair"] + rng.uniform(
        -0.5, 0.5, batch["image_pair"].shape) / 255).astype(np.float32)
    disps = lambda: [rng.uniform(0.3, 3.5, (B, H >> s, W >> s, 1)).astype(np.float32)
                     for s in range(4)]
    pose = lambda: rng.uniform(-0.05, 0.05, (B, 1, 6)).astype(np.float32)
    exps = lambda: [rng.randn(B, H >> s, W >> s, 2).astype(np.float32) for s in range(4)]
    preds = {"single_left": disps(), "single_right": disps(), "pair_left": disps(),
             "pair_right": disps(), "pose_right": pose(), "pose_left": pose(),
             "exp_left": exps(), "exp_right": exps()}
    return batch, preds


def _args(batch, preds, gt_pose: bool, to):
    """The positional arguments of ``lr_full_loss`` / ``lr_gt_pose_loss``."""
    pair = to(batch["image_pair"])
    gt_cam = to(np.concatenate([batch["translation"], batch["rotation"]], -1))
    p = {k: [to(a) for a in v] if isinstance(v, list) else to(v) for k, v in preds.items()}
    single = [] if gt_pose else [p["single_left"], p["single_right"]]
    return (pair[..., :3], pair[..., 3:], *single, p["pair_left"], p["pair_right"],
            p["pose_right"], p["pose_left"], p["exp_left"], p["exp_right"], gt_cam,
            to(batch["intrinsics"]), to(batch["depth0"]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lr_loss_matches_jax(mode):
    """Every component of ``lr_full_loss`` / ``lr_gt_pose_loss`` (the 16 samplings in one
    group call, the plain sampler on the CPU) against JAX's, at rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines

    gt_pose = MODES[mode]
    batch, preds = _loss_inputs()
    jfn = jpipelines.lr_gt_pose_loss if gt_pose else jpipelines.lr_full_loss
    jw = _weights(gt_pose, jax=True)
    _, jcomps = jax.jit(lambda *a: jfn(*a, jw))(*_args(batch, preds, gt_pose, jnp.asarray))
    fn = pipelines.lr_gt_pose_loss if gt_pose else pipelines.lr_full_loss
    w = _weights(gt_pose)
    assert w.sampler == "pallas"
    _, comps = fn(*_args(batch, preds, gt_pose, lambda a: torch.from_numpy(
        np.ascontiguousarray(a))), w)
    ref = {k: float(v) for k, v in jcomps.items()}
    assert sorted(comps) == sorted(ref) and all(v > 0 for v in ref.values())
    for k, v in ref.items():
        np.testing.assert_allclose(float(comps[k]), v, rtol=1e-5, err_msg=k)


# ---- one step from one init in both packages -------------------------------------------

@pytest.fixture(scope="module", params=sorted(MODES))
def step_from_one_init(request, init):
    """(mode, the port's step, JAX's step, the init's params) of one float32 step of each
    package from the same init and batch."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import LRNet as JLRNet
    from tf_depth_estimation_tpu.train import steps as jsteps
    from tf_depth_estimation_tpu.train.state import TrainState, adam

    mode = request.param
    gt_pose, tree = MODES[mode], init[mode]
    params = jax.tree.map(jnp.asarray, tree["params"])
    tx = adam(LR)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=JLRNet(with_single=not gt_pose).apply)
    batch = _demon_batch(4)
    jstep = jsteps.make_lr_gt_step if gt_pose else jsteps.make_lr_full_step
    new, metrics = jax.jit(jstep(_weights(gt_pose, jax=True)))(
        jstate, jax.tree.map(jnp.asarray, batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
    state = create_train_state(LRNet(with_single=not gt_pose), learning_rate=LR)
    state.load_variables(tree)
    step = make_lr_gt_step if gt_pose else make_lr_full_step
    state, metrics = step(_weights(gt_pose))(state, _t(batch))
    variables = state.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}
    return mode, got, ref, _flatten(tree["params"])


def test_one_step_loss_components_match_jax(step_from_one_init):
    _, got, ref, _ = step_from_one_init
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == 1
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=TOL_STEP_LOSS.get(k, 1e-5),
                                   err_msg=k)


def test_one_step_batch_stats_match_jax(step_from_one_init):
    """Running statistics after the train forward, in which each shared submodule moved
    them twice (flax's order: the second pass from the first's result)."""
    _, got, ref, _ = step_from_one_init
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(step_from_one_init):
    """Every parameter within 2 lr of JAX's after Adam's first update, all but 1 % within
    1e-6 (tests/test_torch_train.py)."""
    _, got, ref, init = step_from_one_init
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


# ---- the CLI ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demon_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demon")
    write_demon_h5(os.path.join(str(root), "scenes.h5"), num_scenes=4, H=H, W=W)
    return str(root)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_trains_both_modes(demon_dir, tmp_path, mode):
    """``depth_then_cam_lr.main`` with ``--device cpu --dtype float32`` for 2 steps (and
    ``--gt_pose``): two finite records of the mode's components and a checkpoint that
    reads back into ``LRNet`` of the mode with a finite eval forward."""
    ckpt = str(tmp_path / "ckpt")
    state, _ = depth_then_cam_lr.main([
        "--dataset_dir", demon_dir, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "2",
        "--summary_freq", "1", "--save_latest_freq", "2", "--dtype", "float32",
        "--device", "cpu"] + (["--gt_pose"] if MODES[mode] else []))
    assert state.step == 2 and state.model.with_single == (mode == "full")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    keys = ("total", "pixel", "smooth", "exp", "cam", "consist", "depth") \
        + (("sig",) if MODES[mode] else ())
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records for k in keys)
    variables, meta = load_variables_npz(os.path.join(ckpt, "model-2.npz"))
    model = lrnet_from_variables(variables, device="cpu")
    pair = torch.from_numpy(_demon_batch(9)["image_pair"])
    with torch.no_grad():
        out = model(pair[..., :3], pair[..., 3:])
    assert meta["step"] == "2" and model.with_single == (mode == "full")
    assert all(bool(torch.isfinite(t).all()) for v in out.values()
               for t in (v if isinstance(v, list) else [v]))
    for p in glob.glob(os.path.join(ckpt, "model-*")):   # the weights and Adam's state
        os.remove(p)


def test_cli_defaults_match_jax():
    """Every flag the JAX CLI parses, with its default, and ``--device cuda``."""
    from tf_depth_estimation_tpu.train.experiments import depth_then_cam_lr as jcli

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jcli.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    ref, args = vars(captured["ns"]), vars(depth_then_cam_lr.parse_args([]))
    for k, v in ref.items():
        assert args[k] == v, k
    assert args["device"] == "cuda" and not args["gt_pose"] and not args["demon_v1"]


# ---- on the card -----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_step_launches_the_kernels(mode):
    """One float32 step of each mode at B=2: one forward and one backward sampler launch
    for the step's 16 samplings (dcoords on all, dimgs on the 8 inverse depths), one each
    way for the smoothness group, under ``--gt_pose`` one each way for the sig term; no
    plain sampling and no fused-route launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gt_pose = MODES[mode]
    batch = {k: v.to(dev) for k, v in _t(_demon_batch(10)).items()}
    state = create_train_state(LRNet(with_single=not gt_pose,
                                     generator=torch.Generator().manual_seed(0)).to(dev))
    bs.bilinear_sample.launches = bs.bilinear_sample.backward_launches = 0
    bs.bilinear_sample_reference.calls = 0
    smoothness_fused.launches = smoothness_fused.backward_launches = 0
    sig_l2_fused.launches = sig_l2_fused.backward_launches = 0
    step = make_lr_gt_step if gt_pose else make_lr_full_step
    _, metrics = step(_weights(gt_pose))(state, batch)
    torch.cuda.synchronize()
    assert (bs.bilinear_sample.launches, bs.bilinear_sample.backward_launches) == (1, 1)
    assert (smoothness_fused.launches, smoothness_fused.backward_launches) == (1, 1)
    assert (sig_l2_fused.launches, sig_l2_fused.backward_launches) == \
        ((1, 1) if gt_pose else (0, 0))
    assert bs.bilinear_sample_reference.calls == 0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
