"""The colon-pair families in the port against the JAX package: the sfm and depth4_nobn
DispNet forwards from one init carried across by the weight bridge, the five losses of
``optflow_family`` and ``dim11`` on shared predictions, one float32 ``optflow_only`` step
from one init in both packages, a 3-channel map's smoothness as its channel views,
``DepthPredictor``'s choice of forward, and the six entry points' CLIs. The ``cuda`` test
counts the kernels' launches in an ``optflow_only`` step on the card.

JAX is imported inside the tests and fixtures that use it: the GPU machine has no JAX,
and runs the ``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import argparse
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from torch_fixtures import dim11_dataset, drop_tmp_path  # noqa: F401 (fixtures)
from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
from tf_depth_estimation_torch.infer.predictor import DepthPredictor
from tf_depth_estimation_torch.losses import pipelines
from tf_depth_estimation_torch.losses.basic import second_order_smoothness
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused
from tf_depth_estimation_torch.train.experiments import dim11, optflow_family
from tf_depth_estimation_torch.train.profile_step import pair_batch
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_optflow_only_step
from tf_depth_estimation_torch.utils.npz import _flatten, _unflatten, load_variables_npz
from tf_depth_estimation_torch.weights import (
    dispnet_from_variables,
    load_variables,
    state_dict_to_variables,
)

H, W, B, LR = 32, 64, 2, 2e-4
# float32 forwards: the same products summed in another order (tests/test_fast_infer.py:37)
TOL_FWD = dict(rtol=2e-4, atol=2e-4)
# sfm in train mode: cnv6b..cnv7b see B * 1 * 1 = 2 values per channel at 32x64, and the
# batch norm divides their difference by its own size, so the float32 rounding of the
# convolutions' sums reaches the linear heads as up to 2.0e-3 in 22 of 12,288 values of
# d1 (a CPU run); the heads are linear and cross 0, so the limit is rtol 1e-3 (that of
# tests/test_torch_split.py's train-mode DepthPoseNet forward, for the same cause) with
# an atol of 1e-3 of the head's largest magnitude
TOL_FWD_TRAIN = 1e-3
VARIANTS = ("sfm", "depth4_nobn")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The file runs beside other pytest workers (tests/test_torch_split.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, batch=B):
    """A colon-pair batch of synthetic scenes (pixels in [0, 255]), numpy."""
    return {k: v.numpy() for k, v in pair_batch(batch, H, W, seed, "cpu").items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---- DispNet sfm and depth4_nobn -------------------------------------------------------

@pytest.fixture(scope="module", params=VARIANTS)
def dispnet_init(request):
    """(variant name, a seeded init of the port's DispNet as a JAX variables tree with
    its batch statistics moved off 0 / 1, a 6-channel input [B, H, W, 6])."""
    name = request.param
    model = DispNet(getattr(DispNetVariant, name)(), in_channels=6,
                    generator=torch.Generator().manual_seed(0))
    tree = state_dict_to_variables(model.state_dict())
    rng = np.random.RandomState(5)
    stats = _flatten(tree["batch_stats"])
    assert bool(stats) == (name == "sfm")
    moved = {k: (v + rng.uniform(-0.2, 0.2, v.shape) if k.endswith("mean")
                 else v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
             for k, v in stats.items()}
    tree["batch_stats"] = _unflatten(moved)
    b = _batch(1)
    return name, tree, np.concatenate([b["tgt_image"], b["src_image"]], -1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dispnet_forward_matches_jax(dispnet_init, train):
    """The heads of ``dispnet_from_variables`` against JAX's DispNet of the variant on the
    same tree, eval (running statistics) and train (batch statistics) forwards, and the
    running statistics a train forward leaves."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant

    name, tree, x = dispnet_init
    module = JDispNet(getattr(JVariant, name)())
    model = dispnet_from_variables(tree, device="cpu")
    assert model.variant == getattr(DispNetVariant, name)()
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    variables = jax.tree.map(jnp.asarray, tree if name == "sfm" else
                             {"params": tree["params"]})
    if train and name == "sfm":
        ref, mutated = jax.jit(lambda v, a: module.apply(v, a, train=True, mutable=[
            "batch_stats"]))(variables, jnp.asarray(x))
    else:
        ref = jax.jit(functools.partial(module.apply, train=train))(variables,
                                                                    jnp.asarray(x))
    channels = 3 if name == "sfm" else 1
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        r = np.asarray(r)
        tol = (dict(rtol=TOL_FWD_TRAIN, atol=TOL_FWD_TRAIN * np.abs(r).max())
               if train and name == "sfm" else TOL_FWD)
        assert g.shape[1] == channels
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, **tol)
    if train and name == "sfm":
        stats = _flatten(state_dict_to_variables(model.state_dict())["batch_stats"])
        want = _flatten(jax.tree.map(np.asarray, dict(mutated["batch_stats"])))
        assert sorted(stats) == sorted(want)
        for k in want:
            np.testing.assert_allclose(stats[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_weight_bridge_round_trips_both_variants(dispnet_init):
    """JAX tree -> ``dispnet_from_variables`` -> state dict -> the same tree: depth4_nobn's
    layers carry ``conv.bias`` (a conv with a bias and no batch norm) and keep their
    ``Conv_0`` / ``TFConvTranspose_0`` nodes."""
    name, tree, _ = dispnet_init
    back = state_dict_to_variables(dispnet_from_variables(tree, device="cpu").state_dict())
    a, b = _flatten(tree), _flatten(back)
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    if name == "depth4_nobn":
        assert "params/decoder/upcnv7/TFConvTranspose_0/bias" in a


def test_load_variables_refuses_another_variant_before_loading(dispnet_init):
    """A tree of the other variant (sfm into depth4_nobn and back) raises
    ``RuntimeError`` and leaves every parameter and statistic of the model as it was."""
    name, tree, _ = dispnet_init
    other = "depth4_nobn" if name == "sfm" else "sfm"
    model = DispNet(getattr(DispNetVariant, other)(), in_channels=6,
                    generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="other layers or shapes than DispNet"):
        load_variables(model, tree)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


# ---- the losses ------------------------------------------------------------------------

def _preds(rng, channels, low=0.3, high=3.5):
    return [rng.uniform(low, high, (B, H >> s, W >> s, channels)).astype(np.float32)
            for s in range(4)]


def _loss_case(name: str, seed=3):
    """(the loss function's name in both packages, its preset's name, its positional
    arguments as numpy) of one loss on a colon-pair batch whose images are moved off the
    uint8 grid by up to half a step, so that no photometric error is exactly 0
    (tests/test_torch_depth_then_cam.py)."""
    rng = np.random.RandomState(seed)
    b = _batch(seed)
    for k in ("tgt_image", "src_image"):
        b[k] = (b[k] + rng.uniform(-0.5, 0.5, b[k].shape)).astype(np.float32)
    tgt, src, label, K = b["tgt_image"], b["src_image"], b["label"], b["intrinsics"]
    proj = b["tgt2src_projs"][:, 0]
    if name == "only_image":
        return "only_image_loss", "only_image", (tgt, src, _preds(rng, 1), proj, K)
    if name == "optflow_only":
        fx = [rng.randn(B, H >> s, W >> s, 1).astype(np.float32) for s in range(4)]
        fy = [rng.randn(B, H >> s, W >> s, 1).astype(np.float32) for s in range(4)]
        return "optflow_only_loss", "optflow_only", (tgt, src, fx, fy, label, proj, K)
    if name.startswith("optflow3"):
        return "optflow3_loss", "optflow3", (tgt, src, _preds(rng, 3), label, proj, K)
    if name == "sfm":
        # sfm's linear heads: values of either sign and exact zeros, where 1/pred is
        # infinite and the warp's coordinates are not finite
        preds = [rng.randn(B, H >> s, W >> s, 3).astype(np.float32) for s in range(4)]
        for p in preds:
            p[:, ::3, ::5, 0] = 0.0
        return "multi_source_loss", "sfm_multi", (tgt, [src], preds, label,
                                                  b["tgt2src_projs"], K)
    # dim11: the dim11 loader's [-0.5, 0.5] pixels, small Euler poses, mask logits
    pose = rng.uniform(-0.05, 0.05, (B, 1, 6)).astype(np.float32)
    exps = [rng.randn(B, H >> s, W >> s, 2).astype(np.float32) for s in range(4)]
    return "dim11_joint_loss", "dim11", (tgt / 255 - 0.5, src / 255 - 0.5, _preds(rng, 1),
                                         pose, exps, K, label)


LOSSES = ("only_image", "optflow_only", "optflow3", "optflow3_data", "sfm", "dim11")


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name):
    """Every component of the loss (its warps in one sampler group call, the plain
    sampler on the CPU; sfm's and optflow3's 3-channel smoothness as channel views)
    against JAX's at rtol 1e-5. ``optflow3_data`` turns optflow3's photometric term on
    (data_weight 1; 0 in the preset). A component is finite in both packages or in
    neither (sfm's pixel record warps by 1/pred of heads that cross 0)."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses import pipelines as jpipelines
    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights

    fn, preset, args = _loss_case(name)
    extra = {"data_weight": 1.0} if name == "optflow3_data" else {}
    jw = dataclasses.replace(getattr(JLossWeights, preset)(), height=H, width=W, **extra)
    w = dataclasses.replace(getattr(LossWeights, preset)(), height=H, width=W, **extra)
    conv = lambda to: jax.tree.map(to, args, is_leaf=lambda a: isinstance(a, np.ndarray))
    _, ref = jax.jit(lambda *a: getattr(jpipelines, fn)(*a, jw))(*conv(jnp.asarray))
    _, got = getattr(pipelines, fn)(*conv(torch.from_numpy), w)
    ref = {k: float(v) for k, v in ref.items()}
    assert sorted(got) == sorted(ref)
    assert all(v != 0 for k, v in ref.items() if not (k == "pixel" and name == "optflow3"))
    for k, v in ref.items():
        g = float(got[k])
        assert np.isfinite(g) == np.isfinite(v), (k, g, v)
        if np.isfinite(v):
            np.testing.assert_allclose(g, v, rtol=1e-5, err_msg=k)


def test_three_channel_smoothness_is_the_mean_of_its_channel_views():
    """``_smooth_loss`` routes a C=3 map as its 3 channel views at a third of the
    coefficient: the same value as the plain term of the whole map, and the same
    gradient."""
    rng = np.random.RandomState(7)
    maps = [torch.from_numpy(rng.randn(B, 3, H >> s, W >> s).astype(np.float32))
            .requires_grad_(True) for s in range(4)]
    nhwc = [m.permute(0, 2, 3, 1) for m in maps]
    coefs = [0.1 / 2**s for s in range(4)]
    got = pipelines._smooth_loss(nhwc, coefs)
    ref = sum(c * second_order_smoothness(m) for c, m in zip(coefs, nhwc))
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    g_got = torch.autograd.grad(got, maps)
    g_ref = torch.autograd.grad(ref, maps)
    for a, r in zip(g_got, g_ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-9)


# ---- one step from one init in both packages -------------------------------------------

@pytest.fixture(scope="module")
def optflow_only_step():
    """(the port's step, JAX's step, the init's params) of one float32 ``optflow_only``
    step of each package from the same init (a seeded port init of sfm DispNet carried
    into JAX) and batch; the port on its kernel-#4 preset (the plain sampler on the
    CPU)."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.train import steps as jsteps
    from tf_depth_estimation_tpu.train.state import TrainState, adam

    tree = state_dict_to_variables(DispNet(
        DispNetVariant.sfm(), generator=torch.Generator().manual_seed(0)).state_dict())
    params = jax.tree.map(jnp.asarray, tree["params"])
    tx = adam(LR)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=JDispNet(JVariant.sfm()).apply)
    batch = _batch(4)
    jw = dataclasses.replace(JLossWeights.optflow_only(), height=H, width=W)
    new, metrics = jax.jit(jsteps.make_optflow_only_step(jw))(
        jstate, jax.tree.map(jnp.asarray, batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
    state = create_train_state(DispNet(DispNetVariant.sfm()), learning_rate=LR)
    state.load_variables(tree)
    w = dataclasses.replace(LossWeights.optflow_only(), height=H, width=W)
    assert w.sampler == "pallas"
    state, metrics = make_optflow_only_step(w)(state, _t(batch))
    variables = state.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}
    return got, ref, _flatten(tree["params"])


def test_optflow_only_step_loss_components_match_jax(optflow_only_step):
    got, ref, _ = optflow_only_step
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == 1
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_optflow_only_step_batch_stats_match_jax(optflow_only_step):
    """Running statistics after the train forward (tests/test_torch_train.py's limits)."""
    got, ref, _ = optflow_only_step
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_optflow_only_step_params_match_jax(optflow_only_step):
    """Every parameter within 2 lr of JAX's after Adam's first update, all but 1 % within
    1e-6 (tests/test_torch_train.py)."""
    got, ref, init = optflow_only_step
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


# ---- DepthPredictor's choice of forward --------------------------------------------------

@pytest.mark.parametrize("name", ["depth4", "depth10_flow", "sfm", "depth4_nobn"])
def test_predictor_takes_the_path_jax_takes(name):
    """The port's ``DepthPredictor`` folds exactly the variants JAX's folds (batch norm,
    one decoder, sigmoid heads: depth4); the others serve through the module forward, and
    ``use_fast=True`` raises on them in both packages."""
    from tf_depth_estimation_tpu.infer.predictor import DepthPredictor as JDepthPredictor
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant

    v, jv = getattr(DispNetVariant, name)(), getattr(JVariant, name)()
    tree = state_dict_to_variables(DispNet(v).state_dict())
    kw = dict(height=H, width=W, batch_size=2)
    port = DepthPredictor(tree["params"], tree["batch_stats"], variant=v,
                          dtype=torch.float32, device="cpu", **kw)
    ref = JDepthPredictor(tree["params"], tree["batch_stats"], variant=jv, **kw)
    assert port.uses_fast_path == ref.uses_fast_path == (name == "depth4")
    if name != "depth4":
        with pytest.raises(ValueError):
            DepthPredictor(tree["params"], tree["batch_stats"], variant=v, use_fast=True,
                           device="cpu", **kw)
        with pytest.raises(ValueError):
            JDepthPredictor(tree["params"], tree["batch_stats"], variant=jv, use_fast=True,
                            **kw)
        frames = np.random.RandomState(0).randint(0, 256, (3, H, W, 3), np.uint8)
        out = port.predict_array(frames)
        assert out.shape == (3, H, W) and np.isfinite(out).all()


# ---- the CLIs --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def colon_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colon"))
    return write_colon_pair_dataset(root, num_frames=4, H=48, W=96)


ENTRY_POINTS = (*sorted(optflow_family.MODES), "dim11")


@pytest.mark.parametrize("mode", ENTRY_POINTS)
def test_cli_trains_every_entry_point(colon_dir, dim11_dataset, tmp_path, mode):
    """``optflow_family.main --mode ...`` (48x96 pairs resized to 32x64) and ``dim11.main``
    (32x64 pairs in the dim11 layout, depths in ``--depth_dir``) with ``--device cpu
    --dtype float32`` for 2 steps: two finite records and a checkpoint that reads back
    into the mode's model with a finite eval forward."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--checkpoint_dir", ckpt, "--batch_size", "2", "--max_steps", "2",
              "--summary_freq", "1", "--save_latest_freq", "2", "--dtype", "float32",
              "--device", "cpu"]
    if mode == "dim11":
        data, depth_dir = dim11_dataset
        state, _ = dim11.main(common + ["--dataset_dir", data, "--depth_dir", depth_dir,
                                        "--image_height", str(H), "--image_width", str(W)])
    else:
        state, _ = optflow_family.main(common + [
            "--mode", mode, "--dataset_dir", colon_dir, "--image_height", "48",
            "--image_width", "96", "--resized_height", str(H), "--resized_width", str(W)])
    assert state.step == 2
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["total"]) and np.isfinite(r["smooth"]) for r in records)
    variables, meta = load_variables_npz(os.path.join(ckpt, "model-2.npz"))
    assert meta["step"] == "2"
    if mode == "dim11":
        assert "disp1" in variables["params"]   # the full-resolution DepthPoseNet
    else:
        _, variant, in_ch, _ = optflow_family.MODES[mode]
        model = dispnet_from_variables(variables, device="cpu")
        assert model.variant == variant()
        x = torch.from_numpy(np.random.RandomState(0).rand(1, in_ch, H, W).astype(
            np.float32) * 255)
        with torch.no_grad():
            assert all(bool(torch.isfinite(o).all()) for o in model(x))


@pytest.mark.parametrize("cli", ["optflow_family", "dim11"])
def test_cli_defaults_match_jax(cli):
    """Every flag the JAX CLI parses, with its default, except the flags the port refuses;
    and ``--device cuda``."""
    import importlib

    from tf_depth_estimation_torch.train.experiments.common import NOT_PORTED

    jcli = importlib.import_module(f"tf_depth_estimation_tpu.train.experiments.{cli}")
    port = {"optflow_family": optflow_family, "dim11": dim11}[cli]
    argv = ["--mode", "sfm"] if cli == "optflow_family" else []
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jcli.main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    ref, args = vars(captured["ns"]), vars(port.parse_args(argv))
    for k, v in ref.items():
        if k not in NOT_PORTED:
            assert args[k] == v, k
    assert args["device"] == "cuda"


# ---- on the card -----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_optflow_only_step_launches_the_kernels():
    """One float32 ``optflow_only`` step at B=2: one forward and one backward sampler
    launch for the 4 flow warps, one each way for the smoothness group of 8 flow planes;
    no plain sampling."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    batch = {k: v.to(dev) for k, v in _t(_batch(10)).items()}
    state = create_train_state(DispNet(DispNetVariant.sfm(),
                                       generator=torch.Generator().manual_seed(0)).to(dev))
    bs.bilinear_sample.launches = bs.bilinear_sample.backward_launches = 0
    bs.bilinear_sample_reference.calls = 0
    smoothness_fused.launches = smoothness_fused.backward_launches = 0
    w = dataclasses.replace(LossWeights.optflow_only(), height=H, width=W)
    _, metrics = make_optflow_only_step(w)(state, batch)
    torch.cuda.synchronize()
    assert (bs.bilinear_sample.launches, bs.bilinear_sample.backward_launches) == (1, 1)
    assert (smoothness_fused.launches, smoothness_fused.backward_launches) == (1, 1)
    assert bs.bilinear_sample_reference.calls == 0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
