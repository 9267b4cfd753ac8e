"""``depth_only --turbo`` in the port against the JAX package: one float32 step and a
validation of turbo-colon at 48x144 from one JAX init (TurboDepthNet is NHWC in and out,
DispNet NCHW, so a step that read one layout as the other would train on other shapes),
and the CLI (JAX ``tests/test_experiments.py:117-131``) with its checkpoint served by
``infer/cli.py --mode turbo --checkpoint_group model``."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader
from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.train.experiments import depth_only
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_only_step, make_depth_only_val_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz
from tf_depth_estimation_torch.weights import turbo_from_variables
from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)

H, W, B, LR = 48, 144, 2, 2e-4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colon_turbo"))
    return write_colon_pair_dataset(root, num_frames=6, H=H, W=W)


@pytest.fixture(scope="module")
def runs(dataset):
    """One float32 step and one validation of turbo-colon through each package, from one
    JAX ``create_train_state`` init."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import TurboDepthNet as JTurbo
    from tf_depth_estimation_tpu.models import TurboVariant as JTurboVariant
    from tf_depth_estimation_tpu.train.state import create_train_state as jcreate
    from tf_depth_estimation_tpu.train.steps import make_depth_only_step as jstep
    from tf_depth_estimation_tpu.train.steps import make_depth_only_val_step as jval

    def first_batch(split, n):
        ds = PairDepthDataset(dataset, split=split, image_height=H, image_width=W,
                              resized_height=H, resized_width=W)
        return next(iter(BatchLoader(ds, n, num_workers=1)))

    batch, val_batch = first_batch("train", B), first_batch("val", 1)
    state = jcreate(JTurbo(JTurboVariant.colon(), dtype=jnp.float32),
                    jnp.zeros((B, H, W, 3)), learning_rate=LR)
    init = jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    jw = dataclasses.replace(JLossWeights.depth_only(), height=H, width=W)
    jval_comps = jax.jit(jval(jw))(state, jax.tree.map(jnp.asarray, val_batch))
    new, metrics = jax.jit(jstep(jw))(state, jax.tree.map(jnp.asarray, batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "val": {k: float(v) for k, v in jval_comps.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}

    port = create_train_state(turbo_from_variables(init, TurboVariant.colon(), device="cpu"),
                              learning_rate=LR)
    w = dataclasses.replace(LossWeights.depth_only(), height=H, width=W)
    to_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    pyramid = port.model.eval().forward_nhwc(to_t(batch)["tgt_image"])
    val = make_depth_only_val_step(w)(port, to_t(val_batch))
    port, metrics = make_depth_only_step(w)(port, to_t(batch))
    variables = port.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "val": {k: float(v) for k, v in val.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": port.step,
           "shapes": [tuple(p.shape) for p in pyramid]}
    return got, ref, _flatten(init["params"])


def test_turbo_pyramid_is_nhwc_at_the_four_scales(runs):
    got, _, _ = runs
    assert got["shapes"] == [(B, H >> s, W >> s, 1) for s in range(4)]


def test_one_step_loss_components_match_jax(runs):
    got, ref, _ = runs
    assert got["step"] == 1
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) == ["depth", "smooth", "total"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_one_step_batch_stats_match_jax(runs):
    got, ref, _ = runs
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(runs):
    """Adam's first step: every parameter within 2 lr of JAX's, all but 1 % within 1e-6."""
    got, ref, init = runs
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


def test_val_components_match_jax(runs):
    got, ref, _ = runs
    assert sorted(got["val"]) == sorted(ref["val"]) == ["si_log_rmse", "smooth", "total"]
    for k, v in ref["val"].items():
        np.testing.assert_allclose(got["val"][k], v, rtol=1e-5, err_msg=k)


def test_cli_trains_turbo_and_its_checkpoint_serves(dataset, tmp_path):
    """3 float32 steps of ``--turbo colon`` on the CPU (JAX ``tests/test_experiments.py:
    117-131``); the ``model`` group holds turbo-colon, and the serving CLI reads it with
    ``--checkpoint_group model`` and not under the turbo mode's default group."""
    import PIL.Image as pil

    from tf_depth_estimation_torch.infer import cli

    ckpt = str(tmp_path / "ck")
    state, last = depth_only.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "3",
        "--summary_freq", "3", "--validation_check", "0", "--save_latest_freq", "3",
        "--dtype", "float32", "--device", "cpu", "--turbo", "colon"])
    assert state.step == 3 and isinstance(state.model, TurboDepthNet)
    assert np.isfinite(last["total"])
    variables, _ = load_variables_npz(os.path.join(ckpt, "model-3.npz"))
    turbo_from_variables(variables, TurboVariant.colon(), device="cpu")
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(np.random.RandomState(1).randint(0, 256, (2, H, W, 3), np.uint8)):
        pil.fromarray(img).save(frames / f"f{i}.jpg")
    common = ["--mode", "turbo", "--turbo_variant", "colon", "--checkpoint_dir", ckpt,
              "--dataset_dir", str(frames), "--image_height", str(H), "--image_width",
              str(W), "--out_height", str(H), "--out_width", str(W), "--dtype", "float32",
              "--device", "cpu"]
    written = cli.main(common + ["--checkpoint_group", "model",
                                 "--output_dir", str(tmp_path / "out")])
    assert len(written) == 2
    assert all(np.isfinite(np.fromfile(p, np.float32)).all() for p in written)
    with pytest.raises(FileNotFoundError, match="turbo-<step>.npz"):
        cli.main(common + ["--output_dir", str(tmp_path / "out2")])


@pytest.mark.parametrize("size,error", [
    (("384", "576"), None), (("240", "720"), "turbo-base needs H, W divisible by 32")])
def test_parse_args_checks_the_size_against_the_preset(tmp_path, capsys, size, error):
    """turbo-base takes 576x384 and refuses the default 240x720 with ``TurboVariant``'s
    own message, before any data is read."""
    argv = ["--dataset_dir", str(tmp_path), "--turbo", "base", "--image_height", size[0],
            "--image_width", size[1]]
    if error is None:
        assert depth_only.parse_args(argv).turbo == "base"
        return
    with pytest.raises(SystemExit):
        depth_only.parse_args(argv)
    assert error in capsys.readouterr().err


@pytest.mark.parametrize("variant", ["depth4", "depth10_flow"])
def test_dispnet_forward_nhwc_is_its_forward_in_nhwc(variant):
    """The steps read every model through ``forward_nhwc``: DispNet's is its NCHW forward
    with the image and each output permuted, depths and flows alike."""
    torch.manual_seed(0)
    net = DispNet(getattr(DispNetVariant, variant)()).eval()
    image = torch.rand(1, 64, 96, 3) * 255
    with torch.no_grad():
        got = net.forward_nhwc(image)
        want = net(image.permute(0, 3, 1, 2))
    assert len(got) == len(want) == (8 if variant == "depth10_flow" else 4)
    for g, w in zip(got, want):
        assert g.shape == (1, *w.shape[2:], w.shape[1])
        torch.testing.assert_close(g, w.permute(0, 2, 3, 1), rtol=0, atol=0)
