"""The port's TurboDepthNet serving path against the JAX package, on the CPU at 64x96, B=2,
float32: the nine presets' eval pyramid and ``full_only`` forward, one train-mode forward
with its batch-statistics update, ``fast_turbo_forward``, ``TurboPredictor``, the weight
bridge, the size and name guards and ``infer/cli.py --mode turbo``.

Eight presets load their committed ``weights/turbo_*_distilled_*.npz`` (distilled, so
their batch statistics are real ones); ``atto`` has no committed file and takes a seeded
port init whose statistics a train-mode pass set, carried into JAX. The convs do not
depend on the input size, so the 576x384 weights run at 64x96.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.infer.fast_turbo import fast_turbo_forward as jfast_turbo_forward
from tf_depth_estimation_tpu.infer.predictor import TurboPredictor as JTurboPredictor
from tf_depth_estimation_tpu.models import TurboDepthNet as JTurboDepthNet
from tf_depth_estimation_tpu.models import TurboVariant as JTurboVariant
from tf_depth_estimation_tpu.ops import phase as jphase
from tf_depth_estimation_torch.infer.fast_turbo import fast_turbo_forward
from tf_depth_estimation_torch.infer.predictor import TurboPredictor, _load_frame, _postprocess
from tf_depth_estimation_torch.models.layers import SlimBatchNorm
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.ops import phase
from tf_depth_estimation_torch.utils.npz import load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import (
    state_dict_to_variables,
    turbo_from_variables,
    variables_to_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)            # tests/test_turbo.py:140
TOL_STATS = dict(rtol=2e-4, atol=2e-5)      # batch statistics, as tests/test_torch_train.py
TOL_TURBO_SERVING = (5e-2, 5e-3)            # chip_smoke.py: bf16 serving, (max, mean)
H, W, B = 64, 96, 2
PRESETS = TurboVariant.PRESETS


def weights_path(name):
    hw = "720x240" if name == "colon" else "576x384"
    return os.path.join(ROOT, "weights", f"turbo_{name}_distilled_{hw}.npz")


def _frames(n=B, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, H, W, 3)).astype(np.float32)


def _set_batch_stats(model, x):
    """Running statistics := the batch statistics of ``x`` (one train-mode pass at decay
    0), so that the fold meets statistics that are not the init's zeros and ones."""
    bns = [m for m in model.modules() if isinstance(m, SlimBatchNorm)]
    decay = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    with torch.no_grad():
        model.train()(x)
    for m, d in zip(bns, decay):
        m.momentum = d
    return model.eval()


@pytest.fixture(scope="module")
def variables():
    """preset -> JAX variables tree (numpy)."""
    out = {}
    for name in PRESETS:
        if name == "atto":
            model = TurboDepthNet(TurboVariant.atto(),
                                  generator=torch.Generator().manual_seed(0))
            _set_batch_stats(model, torch.from_numpy(_frames(seed=5)))
            out[name] = state_dict_to_variables(model.state_dict())
        else:
            out[name] = load_variables_npz(weights_path(name))[0]
    return out


@pytest.fixture(scope="module")
def jax_outputs(variables):
    """preset -> (eval pyramid, fast_turbo_forward fold="none") of JAX on ``_frames()``,
    computed on first use. JAX's ``full_only`` output is its pyramid's first level, bit
    for bit (``tests/test_turbo.py::test_full_only_matches_pyramid_head``), so it is not
    compiled again."""
    cache = {}

    def get(name):
        if name not in cache:
            v = JTurboVariant.by_name(name)
            model = JTurboDepthNet(v, dtype=jnp.float32)
            x = jnp.asarray(_frames())
            pyramid = jax.jit(lambda t, x: model.apply(t, x, train=False))(variables[name], x)
            fast = jax.jit(lambda t, x: jfast_turbo_forward(t, x, v, dtype=jnp.float32,
                                                            fold="none"))(variables[name], x)
            cache[name] = ([np.asarray(a) for a in pyramid], np.asarray(fast))
        return cache[name]

    return get


def test_presets_match_jax():
    """Every preset's fields, ``min_hw_multiple`` and the preset list are JAX's."""
    assert TurboVariant.PRESETS == JTurboVariant.PRESETS
    for name in PRESETS:
        port, ref = TurboVariant.by_name(name), JTurboVariant.by_name(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.min_hw_multiple() == ref.min_hw_multiple()


def test_by_name_rejects_unknown():
    with pytest.raises(ValueError, match="unknown turbo variant"):
        TurboVariant.by_name("bsae")
    with pytest.raises(ValueError, match="choose from"):
        TurboVariant.by_name("min_hw_multiple")  # an attribute, not a preset


@pytest.mark.parametrize("name", PRESETS)
def test_eval_forward_matches_jax(variables, jax_outputs, name):
    """The module's eval pyramid and ``full_only`` forward against JAX's."""
    pyramid, _ = jax_outputs(name)
    model = turbo_from_variables(variables[name], TurboVariant.by_name(name), device="cpu")
    x = torch.from_numpy(_frames())
    with torch.no_grad():
        got = model(x)
        (got_full,) = model(x, full_only=True)
    assert [tuple(g.shape) for g in got] == [r.shape for r in pyramid] == [
        (B, H, W, 1), (B, H // 2, W // 2, 1), (B, H // 4, W // 4, 1), (B, H // 8, W // 8, 1)]
    for g, r in zip(got, pyramid):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    np.testing.assert_allclose(got_full.numpy(), pyramid[0], **TOL)
    assert torch.equal(got_full, got[0])


@pytest.mark.parametrize("name", PRESETS)
def test_fast_forward_matches_module_and_jax(variables, jax_outputs, name):
    """``fast_turbo_forward`` (BN folded) against the port's module and JAX's
    ``fast_turbo_forward(fold="none")``, at the committed (or set) statistics."""
    pyramid, jfast = jax_outputs(name)
    v = TurboVariant.by_name(name)
    got = fast_turbo_forward(variables[name], _frames().astype(np.uint8), v,
                             dtype=torch.float32, device="cpu")
    assert got.shape == (B, H, W, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jfast, **TOL)
    np.testing.assert_allclose(got.numpy(), pyramid[0], **TOL)
    module = turbo_from_variables(variables[name], v, device="cpu")
    np.testing.assert_allclose(
        fast_turbo_forward(module, _frames(), v, dtype=torch.float32, device="cpu").numpy(),
        got.numpy(), rtol=0, atol=0)


def test_train_forward_and_stats_update_match_jax(variables):
    """One train-mode forward of ``small``: the pyramid from the batch statistics, and the
    running statistics it leaves (flax's decay 0.99, biased variance)."""
    v = TurboVariant.small()
    x = _frames(seed=3)
    (jpreds, jmut) = jax.jit(lambda t, x: JTurboDepthNet(JTurboVariant.small()).apply(
        t, x, train=True, mutable=["batch_stats"]))(variables["small"], jnp.asarray(x))
    model = turbo_from_variables(variables["small"], v, device="cpu").train()
    with torch.no_grad():
        preds = model(torch.from_numpy(x))
    for g, r in zip(preds, jpreds):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    got = state_dict_to_variables(model.state_dict())["batch_stats"]
    want = jax.tree_util.tree_map(np.asarray, jmut["batch_stats"])
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, r, **TOL_STATS)


@pytest.fixture(scope="module")
def jax_predicted(variables):
    """JAX ``TurboPredictor`` (``small``, f32, batch 2) on 3 frames."""
    tree = variables["small"]
    return JTurboPredictor(tree["params"], tree["batch_stats"], variant=JTurboVariant.small(),
                           height=H, width=W, batch_size=2,
                           dtype=jnp.float32).predict_array(_frames(3, seed=4))


@pytest.mark.parametrize("use_fast", [True, False], ids=["fast", "module"])
def test_predictor_matches_jax(variables, jax_predicted, use_fast):
    """3 frames at batch 2: a full batch and a ragged tail padded to its power of two."""
    frames, want = _frames(3, seed=4), jax_predicted
    tree = variables["small"]
    pred = TurboPredictor(tree["params"], tree["batch_stats"], variant=TurboVariant.small(),
                          height=H, width=W, batch_size=2, dtype=torch.float32,
                          use_fast=use_fast, device="cpu")
    assert pred.uses_fast_path == use_fast
    got = pred.predict_array(frames)
    assert got.shape == (3, H, W)
    np.testing.assert_allclose(got, want, **TOL)
    # integer frames are cast on the device: the same answer
    np.testing.assert_allclose(pred.predict_array(frames.astype(np.uint8)), got, rtol=0,
                               atol=0)


def test_bf16_serving_error_is_within_limits_the_reference_meets(variables):
    """The bf16 folded forward against the f32 module forward of ``small`` at 384x576 on
    2 seeded uint8 frames, in both packages: each within chip_smoke.py's turbo serving
    limits, the port's mean error no larger than JAX's, and JAX's own bf16 forward
    beyond phase 5's 2.5e-2 max (its heads round to bf16), which is why the turbo limit
    is another."""
    v, jv, tree = TurboVariant.small(), JTurboVariant.small(), variables["small"]
    x = np.random.RandomState(12).randint(0, 256, (2, 384, 576, 3)).astype(np.float32)
    jref = jax.jit(lambda t, x: JTurboDepthNet(jv).apply(t, x, train=False,
                                                         full_only=True)[0])(tree, x)
    jbf = jax.jit(lambda t, x: jfast_turbo_forward(t, x, jv, dtype=jnp.bfloat16))(tree, x)
    jdiff = np.abs(np.asarray(jbf, np.float32) - np.asarray(jref))
    with torch.no_grad():
        ref = turbo_from_variables(tree, v, device="cpu")(torch.from_numpy(x),
                                                          full_only=True)[0]
    got = fast_turbo_forward(tree, x.astype(np.uint8), v, dtype=torch.bfloat16,
                             device="cpu")
    diff = (got - ref).abs().numpy()
    errs = {"port": (diff.max(), diff.mean()), "jax": (jdiff.max(), jdiff.mean())}
    for name, (worst, mean) in errs.items():
        assert worst <= TOL_TURBO_SERVING[0] and mean <= TOL_TURBO_SERVING[1], errs
    assert errs["port"][1] <= errs["jax"][1], errs
    assert errs["jax"][0] > 2.5e-2, errs   # why phase 5's max limit is not the turbo one


def test_size_guards(variables):
    tree, v = variables["small"], TurboVariant.small()
    with pytest.raises(ValueError, match="divisible"):
        TurboPredictor(tree["params"], tree["batch_stats"], variant=v, height=60, width=W,
                       device="cpu")
    bad = torch.zeros((1, 60, W, 3))
    with pytest.raises(ValueError, match="divisible"):
        turbo_from_variables(tree, v, device="cpu")(bad)
    with pytest.raises(ValueError, match="divisible"):
        fast_turbo_forward(tree, bad, v, dtype=torch.float32, device="cpu")


def test_weight_bridge_round_trips(variables):
    """JAX tree -> state dict -> JAX tree is exact for every preset, and a module's state
    dict survives the same trip; a tree of another variant does not load."""
    for name in PRESETS:
        tree = variables[name]
        back = state_dict_to_variables(variables_to_state_dict(tree))
        flat = lambda t: {jax.tree_util.keystr(k): a for k, a in
                          jax.tree_util.tree_flatten_with_path(t)[0]}
        want, got = flat(tree), flat(back)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    model = TurboDepthNet(TurboVariant.wide(), generator=torch.Generator().manual_seed(1))
    sd = variables_to_state_dict(state_dict_to_variables(model.state_dict()))
    assert sd.keys() == model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    with pytest.raises(RuntimeError):
        turbo_from_variables(variables["small"], TurboVariant.sprint(), device="cpu")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_space_depth_n_match_jax(n):
    x = np.random.RandomState(n).rand(2, 8, 12, 5).astype(np.float32)
    packed = phase.space_to_depth_n(torch.from_numpy(x), n)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jphase.space_to_depth_n(x, n)))
    y = packed.numpy()
    np.testing.assert_array_equal(phase.depth_to_space_n(packed, n).numpy(), x)
    np.testing.assert_array_equal(phase.depth_to_space_n(torch.from_numpy(y), n).numpy(),
                                  np.asarray(jphase.depth_to_space_n(y, n)))


def _write_frames(directory, n=3):
    import cv2

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(6)
    for i in range(n):
        img = rng.randint(0, 256, (H + 16, W + 24, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(directory, f"frame{i:03d}.jpg"), img)


def test_cli_turbo_mode_follows_the_weights_variant(tmp_path):
    """``--mode turbo --turbo_variant base`` over the ``small`` file: its ``variant``
    metadata wins, and the dumps are the in-process predictor's."""
    frames, out = tmp_path / "frames", tmp_path / "out"
    _write_frames(str(frames))
    proc = subprocess.run(
        [sys.executable, "-m", "tf_depth_estimation_torch.infer.cli", "--mode", "turbo",
         "--turbo_variant", "base", "--weights", weights_path("small"),
         "--dataset_dir", str(frames), "--output_dir", str(out), "--device", "cpu",
         "--dtype", "float32", "--image_height", str(H), "--image_width", str(W),
         "--out_height", "48", "--out_width", "72", "--batch_size", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "wrote 3 depth maps" in proc.stdout
    tree = load_variables_npz(weights_path("small"))[0]
    pred = TurboPredictor(tree["params"], tree["batch_stats"], variant=TurboVariant.small(),
                          height=H, width=W, batch_size=2, dtype=torch.float32,
                          device="cpu")
    paths = sorted(str(p) for p in frames.iterdir())
    want = pred.predict_array(np.stack([_load_frame(p, H, W) for p in paths]))
    for path, z in zip(paths, want):
        got = np.fromfile(out / (os.path.basename(path) + "_z.bin"), np.float32)
        np.testing.assert_allclose(got, _postprocess(z, 48, 72).reshape(-1), **TOL)


def test_cli_rejects_a_tree_of_another_variant(tmp_path, variables):
    """A turbo .npz without ``variant`` metadata is checked against ``--turbo_variant``,
    and the exit names the file and the variant."""
    from tf_depth_estimation_torch.infer import cli

    bare = str(tmp_path / "small_without_meta.npz")
    save_variables_npz(bare, variables["small"])
    with pytest.raises(SystemExit, match=r"small_without_meta\.npz does not match "
                                         r"variant 'base'"):
        cli.main(["--mode", "turbo", "--weights", bare, "--dataset_dir", str(tmp_path),
                  "--output_dir", str(tmp_path / "o"), "--device", "cpu"])
