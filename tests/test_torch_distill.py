"""Distillation in the port against the JAX package (``train/distill.py`` and
``train/experiments/distill_turbo.py``): the loss, one float32 step of a turbo-small student
from a JAX init with the committed depth4 teacher, the eval metrics, the frame batches bit
for bit, the folded teacher against JAX's module teacher, and the CLI with
``--continue_train``. Sizes are 64x96, batch 2."""
import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.models.turbo import TurboVariant
from tf_depth_estimation_torch.train.distill import (
    distill_loss,
    folded_teacher,
    make_distill_eval,
    make_distill_step,
)
from tf_depth_estimation_torch.train.experiments import distill_turbo
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz
from tf_depth_estimation_torch.weights import turbo_from_variables
from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")
H, W, B, LR = 64, 96, 2, 2e-4
TOL_FORWARD = dict(rtol=2e-4, atol=2e-4)   # tests/test_fast_infer.py:37


def _images(seed=0):
    return np.random.RandomState(seed).uniform(0, 255, (B, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def teacher_vars():
    return load_variables_npz(TEACHER)[0]


@pytest.fixture(scope="module")
def jax_run(teacher_vars):
    """A JAX init of turbo-small, then JAX's eval metrics and one float32 distill step on
    one batch, with the teacher module applied in eval mode."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.models import TurboDepthNet as JTurbo
    from tf_depth_estimation_tpu.models import TurboVariant as JTurboVariant
    from tf_depth_estimation_tpu.train.distill import make_distill_eval as jeval
    from tf_depth_estimation_tpu.train.distill import make_distill_step as jstep
    from tf_depth_estimation_tpu.train.state import adam, create_train_state as jcreate

    teacher = JDispNet(JVariant.depth4(), dtype=jnp.float32)
    t_vars = jax.tree.map(jnp.asarray, teacher_vars)
    state = jcreate(JTurbo(JTurboVariant.small(), dtype=jnp.float32),
                    jnp.zeros((B, H, W, 3)), tx=adam(LR))
    init = jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    images = jnp.asarray(_images())
    metrics_eval = jax.jit(jeval(teacher.apply))(state, t_vars, images)
    new, metrics = jax.jit(jstep(teacher.apply))(state, t_vars, images)
    pyramid = teacher.apply(t_vars, images, train=False)
    return {"init": init, "images": np.array(images),
            "eval": {k: float(v) for k, v in metrics_eval.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _flatten(jax.tree.map(np.asarray, new.params)),
            "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats)),
            "teacher": [np.asarray(p) for p in pyramid]}


def _student(init, lr=LR):
    model = turbo_from_variables(init, TurboVariant.small(), device="cpu")
    return create_train_state(model, learning_rate=lr)


@pytest.fixture(scope="module")
def port_run(jax_run, teacher_vars):
    teacher = folded_teacher(teacher_vars, dtype=torch.float32, device="cpu")
    images = torch.from_numpy(jax_run["images"])
    state = _student(jax_run["init"])
    evals = make_distill_eval(teacher)(state, images)
    state, metrics = make_distill_step(teacher)(state, images)
    variables = state.variables()
    return {"eval": {k: float(v) for k, v in evals.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _flatten(variables["params"]),
            "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}


def test_distill_loss_matches_jax():
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.train.distill import distill_loss as jdistill_loss

    rng = np.random.RandomState(3)
    shapes = [(B, H >> s, W >> s, 1) for s in range(4)]
    student = [rng.uniform(0, 4, s).astype(np.float32) for s in shapes]
    teacher = [rng.uniform(0, 4, s).astype(np.float32) for s in shapes]
    weights = (1.0, 0.5, 0.25, 0.125)
    total, comps = distill_loss([torch.from_numpy(a) for a in student],
                                [torch.from_numpy(a) for a in teacher], weights)
    jtotal, jcomps = jdistill_loss([jnp.asarray(a) for a in student],
                                   [jnp.asarray(a) for a in teacher], weights)
    assert sorted(comps) == sorted(jcomps) == [f"distill_l1_s{s}" for s in range(4)] + [
        "total_loss"]
    for k, v in jcomps.items():
        np.testing.assert_allclose(float(comps[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


def test_distill_loss_refuses_other_shapes():
    a, b = torch.zeros(1, 8, 8, 1), torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="scale 0"):
        distill_loss([a], [b], (1.0,))
    with pytest.raises(ValueError, match="teacher scales"):
        distill_loss([a, a], [a], (1.0, 0.5))


def test_folded_teacher_matches_jax_module_teacher(jax_run, teacher_vars):
    """The folded forward with the fused tail's plain version (the CPU) against JAX's
    module ``apply(train=False)``: every scale of the pyramid."""
    got = folded_teacher(teacher_vars, dtype=torch.float32, device="cpu")(
        torch.from_numpy(jax_run["images"]))
    assert len(got) == len(jax_run["teacher"]) == 4
    for g, r in zip(got, jax_run["teacher"]):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, **TOL_FORWARD)


def test_one_step_loss_components_match_jax(jax_run, port_run):
    assert port_run["step"] == 1
    assert sorted(port_run["metrics"]) == sorted(jax_run["metrics"])
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(port_run["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_one_step_batch_stats_match_jax(jax_run, port_run):
    """The student's running statistics after its train forward (the teacher's do not
    move); the tolerance of tests/test_torch_train.py."""
    assert sorted(port_run["batch_stats"]) == sorted(jax_run["batch_stats"])
    for k, v in jax_run["batch_stats"].items():
        np.testing.assert_allclose(port_run["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(jax_run, port_run):
    """Adam's first step: every parameter within 2 lr of JAX's, all but 1 % within 1e-6."""
    init = _flatten(jax_run["init"]["params"])
    total = off = 0
    for k, v in jax_run["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(port_run["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


def test_eval_metrics_match_jax(jax_run, port_run):
    assert sorted(port_run["eval"]) == ["absrel_vs_teacher", "mae_vs_teacher"]
    for k, v in jax_run["eval"].items():
        np.testing.assert_allclose(port_run["eval"][k], v, rtol=1e-5, err_msg=k)


def _args(**kw):
    base = dict(seed=3, frames_glob="", batch_size=B, aug=True, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _both_batches(args, h, w, n=3):
    from tf_depth_estimation_tpu.train.experiments import distill_turbo as jdistill

    ours, theirs = distill_turbo._frame_batches(args, h, w), jdistill._frame_batches(args, h, w)
    return [(next(ours)["image"].numpy(), np.asarray(next(theirs)["image"]))
            for _ in range(n)]


@pytest.mark.parametrize("aug", [True, False])
def test_synthetic_frame_batches_are_jax_batches_bit_for_bit(aug):
    for got, want in _both_batches(_args(aug=aug), 32, 48):
        assert got.dtype == want.dtype == np.float32 and got.shape == (B, 32, 48, 3)
        np.testing.assert_array_equal(got, want)


def test_glob_frame_batches_are_jax_batches_bit_for_bit(tmp_path):
    """JPEGs of another size than the batch's, resized by PIL's BILINEAR, raw 0..255."""
    import PIL.Image as pil

    rng = np.random.RandomState(5)
    for i in range(5):
        pil.fromarray(rng.randint(0, 256, (50, 70, 3), np.uint8)).save(tmp_path / f"{i}.jpg")
    args = _args(frames_glob=str(tmp_path / "*.jpg"), batch_size=3)
    for got, want in _both_batches(args, 32, 48, n=4):
        assert got.shape == (3, 32, 48, 3) and got.max() > 1
        np.testing.assert_array_equal(got, want)


def test_empty_glob_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="matched no files"):
        next(distill_turbo._frame_batches(_args(frames_glob=str(tmp_path / "*.jpg")), H, W))


def test_cli_trains_then_continues(tmp_path):
    """JAX ``tests/test_experiments.py:100-114``: 2 steps, then ``--continue_train`` to 4,
    with a validation every 2 steps and the committed teacher from a checkpoint
    directory; the ``turbo`` group reads back into turbo-small."""
    import shutil

    teacher_dir = tmp_path / "teacher"
    teacher_dir.mkdir()
    shutil.copyfile(TEACHER, teacher_dir / "model-7.npz")
    ckpt = str(tmp_path / "ck")
    common = ["--checkpoint_dir", ckpt, "--turbo_variant", "small", "--image_height",
              str(H), "--image_width", str(W), "--batch_size", "2", "--summary_freq", "2",
              "--validation_check", "2", "--save_latest_freq", "2", "--dtype", "float32",
              "--device", "cpu", "--teacher_checkpoint_dir", str(teacher_dir)]
    state, last = distill_turbo.main(common + ["--max_steps", "2"])
    assert state.step == 2 and np.isfinite(last["total_loss"])
    state, _ = distill_turbo.main(common + ["--max_steps", "4", "--continue_train"])
    assert state.step == 4
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [(r["step"], r["scope"]) for r in records] == [
        (2, "train"), (2, "val"), (4, "train"), (4, "val")]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k != "scope")
    variables, _ = load_variables_npz(os.path.join(ckpt, "turbo-4.npz"))
    turbo_from_variables(variables, TurboVariant.small(), device="cpu")


def test_cli_refuses_a_teacher_directory_without_depth4(tmp_path):
    with pytest.raises(FileNotFoundError, match="model-<step>.npz"):
        distill_turbo.main(["--teacher_checkpoint_dir", str(tmp_path), "--device", "cpu",
                            "--checkpoint_dir", str(tmp_path / "ck")])
    import shutil

    shutil.copyfile(os.path.join(ROOT, "weights", "turbo_small_distilled_576x384.npz"),
                    tmp_path / "model-1.npz")
    with pytest.raises(SystemExit, match="depth4 DispNet"):
        distill_turbo.main(["--teacher_checkpoint_dir", str(tmp_path), "--device", "cpu",
                            "--checkpoint_dir", str(tmp_path / "ck")])
