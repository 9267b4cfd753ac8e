"""Serving from the port's checkpoint directories and ``DepthPredictor``'s forwards:
``infer/cli.py --checkpoint_dir`` in each mode against ``--weights`` of the same file, its
group defaults and its exactly-one-of rule; ``DepthPredictor`` with ``use_fast`` False,
None and True against JAX's predictor, its gate's errors, and depth10_flow through the
module forward. Sizes are 64x96 (32x64 for pairs)."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.infer.predictor import DepthPredictor as JDepthPredictor
from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
from tf_depth_estimation_torch.infer import cli
from tf_depth_estimation_torch.infer.predictor import DepthPredictor
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.utils.npz import load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import state_dict_to_variables
from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")
TURBO_SMALL = os.path.join(ROOT, "weights", "turbo_small_distilled_576x384.npz")
TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_fast_infer.py:37


def _frames(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def teacher():
    return load_variables_npz(TEACHER)[0]


@pytest.fixture(scope="module")
def served(tmp_path_factory, teacher):
    """A checkpoint directory holding ``model-10.npz`` (the teacher), an older
    ``model-9.npz`` (the teacher at half its biases: a newest step taken by name would
    pick it) and ``turbo-5.npz`` (turbo-small), and 3 JPEG frames."""
    import PIL.Image as pil

    root = tmp_path_factory.mktemp("serving")
    ckpt = root / "ck"
    ckpt.mkdir()
    shutil.copyfile(TEACHER, ckpt / "model-10.npz")
    shutil.copyfile(TURBO_SMALL, ckpt / "turbo-5.npz")
    older = {"params": _scaled_biases(teacher["params"]), "batch_stats": teacher["batch_stats"]}
    save_variables_npz(str(ckpt / "model-9.npz"), older)
    frames = root / "frames"
    frames.mkdir()
    for i, img in enumerate(_frames(3, 70, 100, seed=4)):
        pil.fromarray(img).save(frames / f"f{i}.jpg")
    yield {"root": root, "ckpt": str(ckpt), "frames": str(frames)}
    shutil.rmtree(root, ignore_errors=True)


def _scaled_biases(tree):
    return {k: (_scaled_biases(v) if isinstance(v, dict) else
                (v * 0.5 if k == "bias" else v)) for k, v in tree.items()}


def _serve(served, name, argv):
    common = ["--dataset_dir", served["frames"], "--image_height", "64", "--image_width",
              "96", "--out_height", "48", "--out_width", "72", "--batch_size", "2",
              "--dtype", "float32", "--device", "cpu"]
    written = cli.main(common + argv + ["--output_dir", str(served["root"] / name)])
    return [np.fromfile(p, np.float32) for p in written]


@pytest.mark.parametrize("mode,weights,extra", [
    ("depth", TEACHER, []),
    ("turbo", TURBO_SMALL, ["--turbo_variant", "small"]),
])
def test_checkpoint_dir_serves_what_weights_serves(served, mode, weights, extra):
    """The newest step of the mode's default group (``model`` in depth mode, ``turbo`` in
    turbo mode) gives the dumps of ``--weights`` on that file, bit for bit."""
    got = _serve(served, f"{mode}_ck", ["--mode", mode, "--checkpoint_dir", served["ckpt"]]
                 + extra)
    want = _serve(served, f"{mode}_w", ["--mode", mode, "--weights", weights] + extra)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_checkpoint_dir_serves_pairs(tmp_path, served):
    """Pair mode: the truncated DepthPoseNet of ``model-1.npz`` against ``--weights``."""
    variables = state_dict_to_variables(DepthPoseNet(
        full_resolution=False, generator=torch.Generator().manual_seed(0)).state_dict())
    save_variables_npz(str(tmp_path / "model-1.npz"), variables)
    common = ["--mode", "pair", "--image_height", "32", "--image_width", "64"]
    got = _serve(served, "pair_ck", common + ["--checkpoint_dir", str(tmp_path)])
    want = _serve(served, "pair_w", common + ["--weights", str(tmp_path / "model-1.npz")])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_group_names_the_checkpoint_in_the_tree_check(served):
    """``--checkpoint_group model`` in turbo mode reads the teacher, and the tree check
    names the checkpoint it read."""
    with pytest.raises(SystemExit, match=r"model-10\.npz in .* does not match variant"):
        _serve(served, "bad", ["--mode", "turbo", "--turbo_variant", "small",
                               "--checkpoint_dir", served["ckpt"],
                               "--checkpoint_group", "model"])


def test_a_group_without_checkpoints_is_named(served, tmp_path):
    with pytest.raises(FileNotFoundError, match="no turbo-<step>.npz checkpoint"):
        _serve(served, "none", ["--mode", "turbo", "--checkpoint_dir", str(tmp_path)])


@pytest.mark.parametrize("argv", [[], ["--weights", TEACHER, "--checkpoint_dir", "."]])
def test_exactly_one_source_of_weights(served, capsys, argv):
    with pytest.raises(SystemExit):
        _serve(served, "one_of", argv)
    assert "exactly one of --checkpoint_dir / --weights" in capsys.readouterr().err


# ---- DepthPredictor's forwards ---------------------------------------------------------

@pytest.mark.parametrize("use_fast,fast", [(False, False), (None, True), (True, True)])
def test_depth_predictor_matches_jax_predictor(teacher, use_fast, fast):
    """Each ``use_fast`` takes the forward JAX's takes and answers as JAX's predictor
    does."""
    frames = _frames(3, 64, 96, seed=1)
    kw = dict(height=64, width=96, batch_size=2, use_fast=use_fast)
    jpred = JDepthPredictor(teacher["params"], teacher["batch_stats"], dtype=jnp.float32,
                            **kw)
    pred = DepthPredictor(teacher["params"], teacher["batch_stats"], dtype=torch.float32,
                          device="cpu", **kw)
    assert pred.uses_fast_path is jpred.uses_fast_path is fast
    np.testing.assert_allclose(pred.predict_array(frames), jpred.predict_array(frames), **TOL)


def test_depth_predictor_takes_the_module_forward_off_multiples_of_4(teacher):
    """62 rows: ``use_fast=None`` resolves to the module forward in both packages (whose
    decoder, like the reference's, then meets a fed-back head one row short)."""
    kw = dict(height=62, width=96, batch_size=2)
    assert JDepthPredictor(teacher["params"], teacher["batch_stats"], **kw).uses_fast_path \
        is DepthPredictor(teacher["params"], teacher["batch_stats"], device="cpu",
                          **kw).uses_fast_path is False


def test_depth10_flow_is_served_by_the_module_forward():
    variables = state_dict_to_variables(DispNet(
        DispNetVariant.depth10_flow(), generator=torch.Generator().manual_seed(0)).state_dict())
    frames = _frames(2, 64, 96, seed=2)
    kw = dict(height=64, width=96, batch_size=2)
    jpred = JDepthPredictor(variables["params"], variables["batch_stats"],
                            variant=JVariant.depth10_flow(), dtype=jnp.float32, **kw)
    pred = DepthPredictor(variables["params"], variables["batch_stats"],
                          variant=DispNetVariant.depth10_flow(), dtype=torch.float32,
                          device="cpu", **kw)
    assert pred.uses_fast_path is jpred.uses_fast_path is False
    np.testing.assert_allclose(pred.predict_array(frames), jpred.predict_array(frames), **TOL)


@pytest.mark.parametrize("case", ["no_stats", "size", "flow"])
def test_use_fast_true_raises_where_jax_raises(teacher, case):
    stats = None if case == "no_stats" else teacher["batch_stats"]
    hw = (62, 96) if case == "size" else (64, 96)
    variants = ((JVariant.depth10_flow(), DispNetVariant.depth10_flow()) if case == "flow"
                else (None, None))
    with pytest.raises(ValueError, match="use_fast=True requires"):
        JDepthPredictor(teacher["params"], stats, height=hw[0], width=hw[1],
                        variant=variants[0], use_fast=True)
    with pytest.raises(ValueError, match="use_fast=True requires"):
        DepthPredictor(teacher["params"], stats, height=hw[0], width=hw[1],
                       variant=variants[1], use_fast=True, device="cpu")


def test_module_forward_without_statistics_is_refused(teacher):
    """depth4 has batch norm: without statistics neither forward can serve it."""
    with pytest.raises(ValueError, match="needs batch_stats"):
        DepthPredictor(teacher["params"], None, height=64, width=96, device="cpu")
