"""The port's eval forward, module forward and predictor against the JAX package, with
the committed teacher weights at 64x96 (convs do not depend on the input size)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.infer.fast import fast_depth_forward as jfast_depth_forward
from tf_depth_estimation_tpu.infer.predictor import DepthPredictor as JDepthPredictor
from tf_depth_estimation_tpu.models import DispNet as JDispNet, DispNetVariant as JVariant
from tf_depth_estimation_torch.infer.fast import fast_depth_forward
from tf_depth_estimation_torch.infer.predictor import DepthPredictor
from tf_depth_estimation_torch.utils.npz import load_variables_npz
from tf_depth_estimation_torch.weights import dispnet_from_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")
TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_fast_infer.py:37


@pytest.fixture(scope="module")
def teacher():
    variables, _ = load_variables_npz(TEACHER)
    return variables


def _frames(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def jax_refs(teacher):
    """(frames, JAX DispNet.apply eval outputs, JAX fast_depth_forward native outputs)."""
    x = _frames(2, 64, 96)
    xf = jnp.asarray(x.astype(np.float32))
    module = JDispNet(JVariant.depth4(), dtype=jnp.float32).apply(teacher, xf, train=False)
    fast = jfast_depth_forward(teacher, xf, dtype=jnp.float32, tail="native")
    return x, [np.asarray(a) for a in module], [np.asarray(a) for a in fast]


@pytest.mark.parametrize("ref", ["module", "fast"])
@pytest.mark.parametrize("tail", ["fused", "native"])
def test_fast_forward_matches_jax(teacher, jax_refs, tail, ref):
    x, module_ref, fast_ref = jax_refs
    got = fast_depth_forward(teacher, x, dtype=torch.float32, tail=tail, device="cpu")
    want = module_ref if ref == "module" else fast_ref
    assert len(got) == len(want) == 4
    for g, r in zip(got, want):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, **TOL)


def test_module_forward_matches_jax(teacher, jax_refs):
    x, module_ref, _ = jax_refs
    model = dispnet_from_variables(teacher, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).float())
    for g, r in zip(got, module_ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, **TOL)


@pytest.mark.parametrize("tail", ["fused", "native"])
def test_fast_forward_where_resize_like_fires(teacher, tail):
    """72x104: the encoder runs 36, 18, 9, 5, 3, 2, 1 rows, so deconvs overshoot."""
    x = _frames(1, 72, 104, seed=3)
    ref = JDispNet(JVariant.depth4(), dtype=jnp.float32).apply(
        teacher, jnp.asarray(x.astype(np.float32)), train=False)
    got = fast_depth_forward(teacher, x, dtype=torch.float32, tail=tail, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_fast_forward_takes_a_module(teacher, jax_refs):
    x, module_ref, _ = jax_refs
    got = fast_depth_forward(dispnet_from_variables(teacher, device="cpu"), x,
                             dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(got[0].numpy(), module_ref[0], **TOL)


def test_fused_tail_needs_even_sizes(teacher):
    with pytest.raises(ValueError):
        fast_depth_forward(teacher, _frames(1, 33, 48), dtype=torch.float32, device="cpu")


def test_predictor_matches_jax_predictor_on_a_ragged_batch(teacher):
    """5 uint8 frames at batch 4: one full batch and a tail of 1 in its own bucket."""
    frames = _frames(5, 64, 96, seed=1)
    kw = dict(height=64, width=96, batch_size=4)
    want = JDepthPredictor(teacher["params"], teacher["batch_stats"], dtype=jnp.float32,
                           **kw).predict_array(frames)
    pred = DepthPredictor(teacher["params"], teacher["batch_stats"], dtype=torch.float32,
                          device="cpu", **kw)
    got = pred.predict_array(frames)
    assert got.shape == want.shape == (5, 64, 96) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # a 3-frame request rides in a zero-padded bucket of 4 and gets the same answers
    np.testing.assert_allclose(pred.predict_array(frames[:3]), got[:3], **TOL)


def test_predictor_bf16_serving_is_close_to_f32(teacher):
    frames = _frames(3, 64, 96, seed=2)
    kw = dict(height=64, width=96, batch_size=4, device="cpu")
    f32 = DepthPredictor(teacher["params"], teacher["batch_stats"], dtype=torch.float32,
                         **kw).predict_array(frames)
    bf16 = DepthPredictor(teacher["params"], teacher["batch_stats"], **kw).predict_array(
        frames)
    assert np.abs(bf16 - f32).max() < 5e-2   # bf16 through 31 convs on [0, 4] disparities


def test_predictor_rejects_wrong_frame_size(teacher):
    pred = DepthPredictor(teacher["params"], teacher["batch_stats"], height=64, width=96,
                          device="cpu")
    with pytest.raises(ValueError):
        pred.predict_array(_frames(1, 32, 96))


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the same jpgs, float32: the ``_z.bin`` dumps agree."""
    import PIL.Image as pil

    from tf_depth_estimation_tpu.infer import cli as jcli
    from tf_depth_estimation_torch.infer import cli

    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(_frames(3, 80, 120, seed=4)):
        pil.fromarray(img).save(frames / f"f{i}.jpg")
    common = ["--dataset_dir", str(frames), "--weights", TEACHER, "--image_height", "64",
              "--image_width", "96", "--out_height", "48", "--out_width", "72",
              "--batch_size", "2", "--dtype", "float32"]
    got = cli.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    want = jcli.main(common + ["--output_dir", str(tmp_path / "jax")])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        a, b = np.fromfile(g, np.float32), np.fromfile(w, np.float32)
        assert a.shape == (48 * 72,)
        np.testing.assert_allclose(a, b, **TOL)


def test_cli_rejects_other_weights(tmp_path):
    from tf_depth_estimation_torch.infer import cli

    nano = os.path.join(ROOT, "weights", "turbo_nano_distilled_576x384.npz")
    with pytest.raises(SystemExit):
        cli.main(["--dataset_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                  "--weights", nano, "--device", "cpu"])
