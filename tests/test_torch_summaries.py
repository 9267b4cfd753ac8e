"""The port's rich summaries, TensorBoard mirror and profiler hook against the JAX
package's: ``tf1_image_norm``, the pairwise and depth summary functions on the same
variables, the event files of both ``MetricLogger``s, ``run_training(profile_dir=...)``,
and ``depth_only --rich_summaries``."""
import argparse
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.geometry.camera import (
    make_intrinsics_matrix,
    scale_intrinsics_pyramid,
)
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.train import summaries
from tf_depth_estimation_torch.train.loop import MetricLogger, run_training
from tf_depth_estimation_torch.train.state import create_train_state
from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)

H, W, B = 32, 64, 2
# the float maps (histograms) at the forward parity limit of tests/test_fast_infer.py:37;
# the uint8 images within one level (a float difference can cross a rounding step)
TOL_MAPS = dict(rtol=2e-4, atol=1e-5)


def test_tf1_image_norm_is_bit_equal_to_jax():
    from tf_depth_estimation_tpu.train.summaries import tf1_image_norm as jnorm

    rng = np.random.RandomState(0)
    cases = [rng.uniform(0, 3, (3, 5, 7, 1)), rng.uniform(-2, 1, (2, 4, 4, 3)),
             np.zeros((1, 2, 2, 1)), rng.uniform(-1, 0, (2, 3, 3, 1)),
             np.concatenate([rng.uniform(0, 1, (1, 4, 4, 1)), -rng.uniform(0, 1, (1, 4, 4, 1))])]
    for x in cases:
        got = summaries.tf1_image_norm(x.astype(np.float32))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jnorm(x.astype(np.float32)))


def _jax_state(jmodel, example, variables):
    """A JAX ``TrainState`` of ``jmodel`` holding the port's ``variables``."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.train.state import create_train_state as jcreate

    st = jcreate(jmodel, jnp.zeros(example))
    return st.replace(params=variables["params"], batch_stats=variables["batch_stats"])


def _compare(got, want):
    (gi, gh), (wi, wh) = got, want
    assert sorted(gi) == sorted(wi) and sorted(gh) == sorted(wh)
    for k in wi:
        assert gi[k].dtype == np.uint8 and gi[k].shape == wi[k].shape, k
        diff = np.abs(gi[k].astype(int) - wi[k].astype(int))
        assert diff.max() <= 1, (k, diff.max())
    for k in wh:
        np.testing.assert_allclose(gh[k], wh[k], err_msg=k, **TOL_MAPS)


def test_pairwise_summary_matches_jax():
    """The truncated DepthPoseNet (a seeded port init, in both packages) on 2 pairs and
    the fixture pair: every image within one level, every histogram within 2e-4."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet
    from tf_depth_estimation_tpu.train.summaries import make_pairwise_summary_fn as jfn

    from tf_depth_estimation_torch.train.experiments.common import fixture_pair

    model = DepthPoseNet(full_resolution=False, generator=torch.Generator().manual_seed(1))
    state = create_train_state(model)
    variables = state.variables()
    rng = np.random.RandomState(0)
    K = make_intrinsics_matrix(torch.full((B,), 50.0), torch.full((B,), 50.0),
                               torch.full((B,), W / 2), torch.full((B,), H / 2))
    batch = {"image_pair": rng.rand(B + 1, H, W, 6).astype(np.float32) - 0.5,
             "depth0": rng.uniform(0.5, 2, (B + 1, H, W, 1)).astype(np.float32),
             "intrinsics": scale_intrinsics_pyramid(K, 4).numpy()}
    batch["intrinsics"] = np.concatenate([batch["intrinsics"], batch["intrinsics"][:1]])
    fixture = fixture_pair(argparse.Namespace(fixture_images=None), H, W)
    w = dataclasses.replace(LossWeights.split_training(), height=H, width=W)
    got = summaries.make_pairwise_summary_fn(w, fixture)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.model.training   # the summary's eval forward leaves the mode as it was
    jw = dataclasses.replace(JLossWeights.split_training(), height=H, width=W)
    jstate = _jax_state(JDepthPoseNet(full_resolution=False, dtype=jnp.float32),
                        (B, H, W, 6), variables)
    want = jfn(jw, fixture)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _compare(got, want)
    assert {"scale0_projected_image_left", "val_depth", "val_image"} <= set(got[0])
    assert got[0]["scale0_left_image"].shape[0] == B   # max_images


def test_depth_summary_matches_jax():
    """depth4 DispNet (a seeded port init) on 2 images with a label holding NaN and inf:
    the images within one level, the histograms within 2e-4, the non-finite label values
    0 in both."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.train.summaries import make_depth_summary_fn as jfn

    state = create_train_state(DispNet(DispNetVariant.depth4(),
                                       generator=torch.Generator().manual_seed(2)))
    rng = np.random.RandomState(1)
    batch = {"tgt_image": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
             "label": rng.uniform(0.5, 2, (B, H, W, 1)).astype(np.float32)}
    batch["label"][0, 0, 0, 0], batch["label"][1, 3, 4, 0] = np.nan, np.inf
    w = dataclasses.replace(LossWeights.depth_only(), height=H, width=W)
    got = summaries.make_depth_summary_fn(w)(state, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    jstate = _jax_state(JDispNet(JVariant.depth4(), dtype=jnp.float32), (B, H, W, 3),
                        state.variables())
    jw = dataclasses.replace(JLossWeights.depth_only(), height=H, width=W)
    want = jfn(jw)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _compare(got, want)
    assert got[1]["scale_depth"][0, 0, 0, 0] == got[1]["scale_depth"][1, 3, 4, 0] == 0.0


def _events(directory: str) -> dict:
    """{kind: {tag: [(step, value or None)]}} of every event file under ``directory``:
    scalars with their values, images and histograms by tag, whichever way the writer
    stored them (TF2 tensor summaries with plugin data, or PyTorch's simple values,
    images and histos)."""
    tf = pytest.importorskip("tensorflow")
    out = {"scalars": {}, "images": {}, "histograms": {}}
    for path in glob.glob(os.path.join(directory, "events.*")):
        for e in tf.compat.v1.train.summary_iterator(path):
            for v in e.summary.value:
                field = v.WhichOneof("value")
                plugin = v.metadata.plugin_data.plugin_name
                if field == "simple_value" or plugin == "scalars":
                    value = (v.simple_value if field == "simple_value"
                             else float(tf.make_ndarray(v.tensor)))
                    out["scalars"].setdefault(v.tag, []).append((e.step, value))
                elif field == "image" or plugin == "images":
                    out["images"].setdefault(v.tag, []).append((e.step, None))
                elif field == "histo" or plugin == "histograms":
                    out["histograms"].setdefault(v.tag, []).append((e.step, None))
    return out


def test_event_files_hold_jaxs_tags_steps_and_values(tmp_path):
    """Both loggers fed the same records, images and histograms: the same scalar tags
    (``<scope>/<metric>``), steps and values, and the same image and histogram tags."""
    pytest.importorskip("tensorflow")
    from tf_depth_estimation_tpu.train.loop import MetricLogger as JMetricLogger

    rng = np.random.RandomState(2)
    images = {"target_image": rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8),
              "scale0_pred_depth": rng.randint(0, 256, (2, 8, 12, 1)).astype(np.uint8)}
    hists = {"scale0_pred_depth": rng.rand(2, 8, 12, 1).astype(np.float32)}
    for cls, name in ((MetricLogger, "port"), (JMetricLogger, "jax")):
        logger = cls(str(tmp_path / name), quiet=True, tensorboard=True)
        logger.log(1, "train", {"total": 1.25, "depth": 0.5})
        logger.log(2, "train", {"total": 1.125, "depth": 0.375})
        logger.log(2, "val", {"si_log_rmse": 0.75})
        logger.log_images(2, images)
        logger.log_histograms(2, hists)
        logger.close()
    got, want = _events(str(tmp_path / "port" / "sum")), _events(str(tmp_path / "jax" / "sum"))
    assert sorted(want["scalars"]) == ["train/depth", "train/total", "val/si_log_rmse"]
    assert got["scalars"].keys() == want["scalars"].keys()
    for tag, rows in want["scalars"].items():
        assert [s for s, _ in got["scalars"][tag]] == [s for s, _ in rows], tag
        np.testing.assert_allclose([v for _, v in got["scalars"][tag]],
                                   [v for _, v in rows], rtol=1e-7, err_msg=tag)
    assert got["images"] == want["images"] and sorted(got["images"]) == sorted(images)
    assert got["histograms"] == want["histograms"] == {"scale0_pred_depth": [(2, None)]}


def test_logger_without_tensorboard_says_so(tmp_path, capsys, monkeypatch):
    """Where the tensorboard package is missing: JAX's "tensorboard writer unavailable"
    line, the JSONL records as before, and the image summaries do nothing."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricLogger(str(tmp_path), quiet=True, tensorboard=True)
    assert "tensorboard writer unavailable" in capsys.readouterr().out
    logger.log(1, "train", {"total": 1.0})
    logger.log_images(1, {"x": np.zeros((1, 2, 2, 1), np.uint8)})
    logger.close()
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        assert json.loads(f.read())["total"] == 1.0
    assert not os.path.exists(os.path.join(str(tmp_path), "sum"))


def test_run_training_profile_dir_writes_one_trace(tmp_path):
    """``profile_dir`` records steps [1, 3) of 4 as one Chrome trace holding the steps'
    operations."""
    model = torch.nn.Linear(3, 1)
    state = create_train_state(model, learning_rate=0.1)

    def step(st, batch):
        st.optimizer.zero_grad()
        loss = st.model(batch["x"]).square().mean()
        loss.backward()
        st.optimizer.step()
        st.step += 1
        return st, {"total": loss.detach()}

    batches = iter([{"x": torch.ones(2, 3) * i} for i in range(4)])
    logger = MetricLogger(str(tmp_path / "log"), quiet=True)
    run_training(state=state, train_step=step, batches=batches, max_steps=4, logger=logger,
                 summary_freq=1, profile_dir=str(tmp_path / "prof"), profile_steps=(1, 3))
    logger.close()
    traces = glob.glob(str(tmp_path / "prof" / "*"))
    assert [os.path.basename(p) for p in traces] == ["steps_1-3.pt.trace.json"]
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::linear" in names, sorted(n for n in names if n)[:20]


def test_depth_only_rich_summaries_write_images_and_histograms(tmp_path):
    """``depth_only --rich_summaries`` (implying ``--tensorboard``) for 2 steps with
    ``--image_summary_freq 2``: the scalars every step and the summary set at step 2."""
    pytest.importorskip("tensorboard")
    from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
    from tf_depth_estimation_torch.train.experiments import depth_only

    data = write_colon_pair_dataset(str(tmp_path / "data"), num_frames=4, H=H, W=W)
    ckpt = str(tmp_path / "ck")
    state, _ = depth_only.main([
        "--dataset_dir", data, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "2",
        "--summary_freq", "1", "--validation_check", "100", "--image_summary_freq", "2",
        "--rich_summaries", "--device", "cpu", "--dtype", "float32"])
    assert state.step == 2
    ev = _events(os.path.join(ckpt, "sum"))
    assert [s for s, _ in ev["scalars"]["train/total"]] == [1, 2]
    assert set(ev["images"]) == {"target_image"} | {f"scale{s}_pred_depth" for s in range(4)}
    assert set(ev["histograms"]) == {"image_value_range", "scale0_pred_depth",
                                     "scale_depth"}
    assert all(rows == [(2, None)] for rows in ev["images"].values())


def test_viz_and_constants_equal_jaxs():
    """``normalize_depth_for_display`` (percentile and given normaliser, crop, colour
    map) and the serving target equal the JAX package's."""
    from tf_depth_estimation_tpu.utils import constants as jconstants
    from tf_depth_estimation_tpu.utils import viz as jviz

    from tf_depth_estimation_torch.utils import constants, viz

    depth = np.random.RandomState(3).uniform(0.5, 4.0, (12, 20)).astype(np.float32)
    for kw in ({}, {"pc": 50, "crop_percent": 0.25}, {"normalizer": 1.5, "cmap": "plasma"}):
        got = viz.normalize_depth_for_display(depth, **kw)
        assert got.shape[-1] == 3
        np.testing.assert_array_equal(got, jviz.normalize_depth_for_display(depth, **kw))
    assert constants.NORTH_STAR_FPS == jconstants.NORTH_STAR_FPS
