"""BASELINE config 5 in the port against the JAX package: ``on_demon_loss`` in value and
gradient (the total of both modes), one float32 step of ``make_on_demon_step`` from one init
in both packages, and the ``on_demon`` CLI with ``--optimize_depth``. The ``cuda`` test
counts the smoothness kernel's launches in a config-5 step on the card.

JAX is imported inside the tests and fixtures that use it: the GPU machine has no JAX,
and runs the ``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import argparse
import dataclasses
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
from tf_depth_estimation_torch.models import DepthPoseNet
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused
from tf_depth_estimation_torch.train.experiments import on_demon
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_on_demon_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz
from tf_depth_estimation_torch.weights import depth_pose_from_variables, state_dict_to_variables

H, W, B, LR = 32, 64, 2, 2e-4
# one step's loss components, port against JAX: the depth L1 at rtol 1e-5, the smoothness
# (and the total, which is the smoothness) at 5e-5: the second differences of the random
# init's nearly flat 1/disp3 and 1/disp4 amplify the two float32 forwards' rounding (the
# deepest batch norms see 2 values at B=2 and 32x64), as tests/test_torch_split.py's sig
# term does; on the same predictions test_on_demon_loss_matches_jax holds them to 1e-5
TOL_STEP_LOSS = {"smooth": 5e-5, "total": 5e-5}


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


def _weights(jax: bool = False):
    if jax:
        from tf_depth_estimation_tpu.losses.config import LossWeights as table
    else:
        table = LossWeights
    return dataclasses.replace(table.on_demon(), height=H, width=W)


@pytest.mark.parametrize("smooth_only", [True, False], ids=["smooth_only", "with_depth"])
def test_on_demon_loss_matches_jax(smooth_only):
    """Every component at rtol 1e-5, and the gradient of the total in each prediction, for
    the truncated net's [disp3, disp4] at scales 2 and 3 (the plain smoothness term on the
    CPU); the total is the smoothness alone unless ``smooth_only=False``."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines

    rng = np.random.RandomState(3)
    label = _demon_batch(3)["depth0"]
    preds = [rng.uniform(0.3, 3.5, (B, H >> s, W >> s, 1)).astype(np.float32)
             for s in (2, 3)]
    jw = _weights(jax=True)
    (_, jcomps), jgrads = jax.jit(jax.value_and_grad(
        lambda p, lab: jpipelines.on_demon_loss(p, lab, jw, scale_offset=2,
                                                smooth_only=smooth_only), has_aux=True))(
        [jnp.asarray(p) for p in preds], jnp.asarray(label))
    leaves = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    total, comps = pipelines.on_demon_loss(leaves, torch.from_numpy(label), _weights(),
                                           scale_offset=2, smooth_only=smooth_only)
    total.backward()
    ref = {k: float(v) for k, v in jcomps.items()}
    assert sorted(comps) == sorted(ref) and all(v > 0 for v in ref.values())
    assert ref["total"] == pytest.approx(ref["smooth"] + (0 if smooth_only else ref["depth"]))
    for k, v in ref.items():
        np.testing.assert_allclose(float(comps[k]), v, rtol=1e-5, err_msg=k)
    for g, r in zip(leaves, jgrads):
        r = np.asarray(r)
        np.testing.assert_allclose(g.grad.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max())


# ---- one step from one init in both packages -------------------------------------------

@pytest.fixture(scope="module")
def step_from_one_init():
    """One float32 config-5 step through each package from the same init (a seeded init of
    the port's truncated DepthPoseNet carried into JAX) and batch."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet
    from tf_depth_estimation_tpu.train.state import TrainState, adam
    from tf_depth_estimation_tpu.train.steps import make_on_demon_step as jstep

    init = state_dict_to_variables(DepthPoseNet(
        generator=torch.Generator().manual_seed(0)).state_dict())
    params = jax.tree.map(jnp.asarray, init["params"])
    tx = adam(LR)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, init["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=JDepthPoseNet(full_resolution=False).apply)
    batch = _demon_batch(4)
    new, metrics = jax.jit(jstep(_weights(jax=True)))(jstate,
                                                      jax.tree.map(jnp.asarray, batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
    state = create_train_state(DepthPoseNet(), learning_rate=LR)
    state.load_variables(init)
    state, metrics = make_on_demon_step(_weights())(
        state, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    variables = state.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}
    return got, ref, _flatten(init["params"])


def test_one_step_loss_components_match_jax(step_from_one_init):
    got, ref, _ = step_from_one_init
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == 1
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=TOL_STEP_LOSS.get(k, 1e-5),
                                   err_msg=k)


def test_one_step_batch_stats_match_jax(step_from_one_init):
    got, ref, _ = step_from_one_init
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(step_from_one_init):
    """Every parameter within 2 lr of JAX's after Adam's first update, all but 1 % within
    1e-6 (tests/test_torch_train.py). The layers the smoothness of disp3 and disp4 does not
    reach (the pose and explainability heads) keep their init in both."""
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
    assert np.array_equal(got["params"]["pose_pred/Conv_0/kernel"],
                          init["pose_pred/Conv_0/kernel"])


# ---- the CLI ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demon_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demon")
    write_demon_h5(os.path.join(str(root), "scenes.h5"), num_scenes=4, H=H, W=W)
    return str(root)


def test_cli_trains_config_5_with_optimize_depth(demon_dir, tmp_path):
    """``on_demon.main --optimize_depth`` with ``--device cpu --dtype float32`` for 2 steps:
    two finite records whose total is smooth + depth, and a checkpoint that reads back into
    the truncated DepthPoseNet with a finite eval forward."""
    ckpt = str(tmp_path / "ckpt")
    state, _ = on_demon.main([
        "--dataset_dir", demon_dir, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "2",
        "--summary_freq", "1", "--save_latest_freq", "2", "--dtype", "float32",
        "--device", "cpu", "--optimize_depth"])
    assert state.step == 2 and not state.model.full_resolution
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records for k in ("total", "smooth", "depth"))
    assert all(r["total"] == pytest.approx(r["smooth"] + r["depth"], rel=1e-6)
               for r in records)
    variables, meta = load_variables_npz(os.path.join(ckpt, "model-2.npz"))
    model = depth_pose_from_variables(variables, device="cpu")
    with torch.no_grad():
        disps, pose, masks = model(torch.from_numpy(_demon_batch(9)["image_pair"])
                                   .permute(0, 3, 1, 2))
    assert meta["step"] == "2" and not model.full_resolution and len(disps) == 2
    assert all(bool(torch.isfinite(t).all()) for t in (*disps, pose, *masks))
    for p in glob.glob(os.path.join(ckpt, "model-*")):
        os.remove(p)


def test_cli_defaults_match_jax():
    """Every flag the JAX CLI parses, with its default (batch 16, 200,000 steps, a save
    every 100, 192x256); and ``--device cuda``."""
    from tf_depth_estimation_tpu.train.experiments import on_demon as jcli

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
    ref, args = vars(captured["ns"]), vars(on_demon.parse_args([]))
    for k, v in ref.items():
        assert args[k] == v, k
    assert (args["batch_size"], args["max_steps"], args["save_latest_freq"]) == \
        (16, 200000, 100)
    assert args["device"] == "cuda" and not args["optimize_depth"]


@pytest.mark.parametrize("config", ["on_demon", "lr_gt"])
def test_profile_step_demon_configs_take_the_clis_setup(config):
    """``profile_step``'s DeMoN configs build their weights from the CLI (the L/R one
    under ``--gt_pose``) at the size asked, swap only the sampler for ``plain``, and
    profile a step at a small size; on the CPU they see no device kernels."""
    from tf_depth_estimation_torch.train import profile_step
    from tf_depth_estimation_torch.train.experiments import depth_then_cam_lr

    cli, flags = (on_demon, []) if config == "on_demon" else (depth_then_cam_lr, ["--gt_pose"])
    want = dataclasses.replace(cli.loss_weights(cli.parse_args(flags)), height=H, width=W)
    for sampler in ("kernel", "plain"):
        w, _, _, data = profile_step.CONFIGS[config](1, H, W, "cpu", sampler)
        assert w == (want if sampler == "kernel" else dataclasses.replace(want, sampler="xla"))
        assert data["image_pair"].shape == (1, H, W, 6)
    out = profile_step.profile(steps=1, device="cpu", batch=1, height=H, width=W,
                               config=config)
    assert out["wall_ms"] > 0 and out["launches"] == 0 and out["kind_launches"] == {}


# ---- on the card -----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_step_launches_the_smoothness_kernel():
    """One float32 config-5 step at B=2: one forward and one backward smoothness launch for
    the two maps, and no sampler launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in _demon_batch(10).items()}
    state = create_train_state(DepthPoseNet(
        generator=torch.Generator().manual_seed(0)).to(dev))
    smoothness_fused.launches = smoothness_fused.backward_launches = 0
    bs.bilinear_sample.launches = bs.bilinear_sample_reference.calls = 0
    _, metrics = make_on_demon_step(_weights())(state, batch)
    torch.cuda.synchronize()
    assert (smoothness_fused.launches, smoothness_fused.backward_launches) == (1, 1)
    assert bs.bilinear_sample.launches == 0 and bs.bilinear_sample_reference.calls == 0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
