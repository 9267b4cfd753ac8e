"""Config-4 training in the port against the JAX package: one float32 step from a JAX
init, Adam against optax, the host batches, and the CLI's checkpoints read by JAX."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_depth_estimation_tpu.data.colon import PairDepthDataset as JPairDepthDataset
from tf_depth_estimation_tpu.data.pipeline import BatchLoader as JBatchLoader
from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
from tf_depth_estimation_tpu.models import DispNet as JDispNet
from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
from tf_depth_estimation_tpu.train import checkpoint as jckpt
from tf_depth_estimation_tpu.train.state import create_train_state as jcreate_train_state
from tf_depth_estimation_tpu.train.steps import make_optflow_combine_step as jmake_step
from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader
from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models import DispNet, DispNetVariant
from tf_depth_estimation_torch.train.experiments import optflow_combine
from tf_depth_estimation_torch.train.state import adam, create_train_state
from tf_depth_estimation_torch.train.steps import make_optflow_combine_step
from tf_depth_estimation_torch.utils.npz import _flatten
from tf_depth_estimation_torch.weights import dispnet_from_variables

H, W, B, LR = 64, 96, 2, 2e-4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colon"))
    return write_colon_pair_dataset(root, num_frames=8, H=H, W=W)


@pytest.fixture(scope="module")
def one_step(dataset):
    """The same JAX init and batch through one float32 step of each package."""
    batch = next(iter(BatchLoader(PairDepthDataset(dataset, image_height=H, image_width=W,
                                                   resized_height=H, resized_width=W),
                                  B, num_workers=1)))
    state = jcreate_train_state(JDispNet(JVariant.depth10_flow(), dtype=jnp.float32),
                                jnp.zeros((B, H, W, 3)), learning_rate=LR)
    init = jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    jw = dataclasses.replace(JLossWeights.optflow_combine(), height=H, width=W)
    new, metrics = jax.jit(jmake_step(jw))(state, jax.tree.map(jnp.asarray, batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}

    port = create_train_state(DispNet(DispNetVariant.depth10_flow()), learning_rate=LR)
    port.load_variables(init)
    w = dataclasses.replace(LossWeights.optflow_combine(), height=H, width=W)
    port, metrics = make_optflow_combine_step(w)(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})
    variables = port.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": port.step}
    return got, ref, _flatten(init["params"])


def test_one_step_loss_components_match_jax(one_step):
    got, ref, _ = one_step
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == 1
    for k, v in ref["metrics"].items():   # the same forward, sums in another order
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_one_step_batch_stats_match_jax(one_step):
    """Running statistics after the train forward: 0.999 * init + 0.001 * batch. The batch
    statistics of this small input agree to ~5e-5 relative (the biased fast variance of
    0-255 inputs cancels digits, and deep layers see B * 1 * 1 values per channel)."""
    got, ref, _ = one_step
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(one_step):
    """After Adam's first step every parameter has moved by lr * g / (|g| + 1e-8), about
    lr * sign(g), from the same init. The float32 gradients of this batch are themselves
    only good to 1-3 % per tensor (JAX float32 against float64 on the same input), so
    where |g| is below that error its sign, and the parameter, can differ by 2 lr. The
    test holds every parameter within 2 lr of JAX's and all but 1 % of them within 1e-6
    (0.3 % differ in a CPU run)."""
    got, ref, init = one_step
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        moved = np.abs(v - init[k])
        assert moved.max() <= LR * (1 + 1e-4), k           # Adam's first step
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


def test_adam_matches_optax():
    """torch.optim.Adam(betas=(b1, 0.999), eps=1e-8) = optax.adam: lr * m_hat /
    (sqrt(v_hat) + eps), over steps with gradients of varying size and sign."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64).astype(np.float32)
    grads = [(rng.randn(64) * 10.0 ** rng.uniform(-9, 1, 64)).astype(np.float32)
             for _ in range(5)]
    tx = optax.adam(1e-3, b1=0.8, b2=0.999, eps=1e-8)
    p = jnp.asarray(p0)
    opt = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer = adam([param], 1e-3, beta1=0.8)
    for g in grads:
        updates, opt = tx.update(jnp.asarray(g), opt, p)
        p = optax.apply_updates(p, updates)
        param.grad = torch.from_numpy(g)
        optimizer.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p), rtol=1e-6, atol=1e-7)


def test_pair_batches_match_jax(dataset):
    """PairDepthDataset + BatchLoader give JAX's batches for one seed (one worker, so the
    order is fixed): the same decode, TF1 resizes, intrinsics pyramid and projections.
    The port's host resizes sum through BLAS in another order: float32 rounding on
    pixels in [0, 255] and depths in [0.4, 3.75]."""
    kw = dict(image_height=H, image_width=W, resized_height=32, resized_width=64)
    ours = iter(BatchLoader(PairDepthDataset(dataset, **kw), 2, seed=3, num_workers=1))
    ref = iter(JBatchLoader(JPairDepthDataset(dataset, **kw), 2, seed=3, num_workers=1))
    for _ in range(4):    # four batches of 2 from 4 train frames: two epochs
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-5, err_msg=k)


def _cli(dataset, ckpt, *extra):
    return optflow_combine.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--resized_height", "32", "--resized_width", "64",
        "--batch_size", "2", "--summary_freq", "1", "--device", "cpu",
        "--dtype", "float32", *extra])


@pytest.fixture(scope="module")
def cli_run(dataset, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    state, last = _cli(dataset, ckpt, "--max_steps", "3")
    return ckpt, state, last


def test_cli_checkpoint_is_read_by_jax(cli_run):
    """The .npz the CLI writes after 3 steps loads in JAX; JAX's eval forward of
    DispNet(depth10_flow) matches the port's at rtol 2e-4 (tests/test_fast_infer.py)."""
    ckpt, state, last = cli_run
    assert state.step == 3 and all(np.isfinite(v) for v in last.values())
    path = os.path.join(ckpt, "model-3.npz")
    variables, meta = jckpt.load_variables_npz(path)
    assert meta["step"] == "3" and sorted(variables) == ["batch_stats", "params"]
    x = np.random.RandomState(5).uniform(0, 255, (2, 32, 64, 3)).astype(np.float32)
    ref = JDispNet(JVariant.depth10_flow()).apply(variables, jnp.asarray(x), train=False)
    model = dispnet_from_variables(variables, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=2e-4, atol=2e-4)


def test_cli_resumes_with_continue_train(cli_run, dataset):
    ckpt, state, _ = cli_run
    resumed, last = _cli(dataset, ckpt, "--max_steps", "4", "--continue_train")
    assert resumed.step == 4 and os.path.exists(os.path.join(ckpt, "model-4.npz"))
    adam_state = resumed.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 4 for s in adam_state.values())


@pytest.mark.parametrize("flag", ["--native_loader", "--tensorboard", "--rich_summaries"])
def test_cli_refuses_flags_of_later_slices(flag, tmp_path):
    """The three flags earlier slices refused are ported: the parser takes each as the
    JAX CLI does (no refusal), and the run goes on to read the dataset (an empty
    directory here, so the reader raises, not the parser)."""
    from tf_depth_estimation_tpu.train.experiments.common import base_parser

    argv = ["--dataset_dir", str(tmp_path), flag, "--device", "cpu"]
    assert getattr(optflow_combine.parse_args(argv), flag[2:]) is True
    assert getattr(base_parser("jax").parse_args(argv[:3]), flag[2:]) is True
    with pytest.raises(FileNotFoundError):
        optflow_combine.main(argv)


def test_cli_accepts_demon_v1_unread(tmp_path):
    """``--demon_v1`` is accepted, and left unread, by a CLI that reads no DeMoN data, as
    the JAX CLI accepts it (its parser is JAX's common one)."""
    import inspect

    args = optflow_combine.parse_args(["--dataset_dir", str(tmp_path), "--demon_v1",
                                       "--device", "cpu"])
    assert args.demon_v1 is True
    assert "demon" not in inspect.getsource(optflow_combine)


# the flags of the JAX CLIs that the port accepts without reading them further (JAX reads
# none of them on these paths but --validation_check), with a value and its parsed form
JAX_FLAGS = [("--validate_dir", "val/", "val/"), ("--validation_check", "7", 7),
             ("--init_checkpoint_file", "init.npz", "init.npz"),
             ("--image_summary_freq", "9", 9), ("--fixture_images", "a.png,b.png",
                                                   "a.png,b.png")]


@pytest.mark.parametrize("flag,value,parsed", JAX_FLAGS)
def test_cli_accepts_the_flags_of_the_jax_cli(flag, value, parsed, tmp_path):
    args = optflow_combine.parse_args(["--dataset_dir", str(tmp_path), flag, value,
                                       "--device", "cpu"])
    assert getattr(args, flag[2:]) == parsed


def test_cli_defaults_of_those_flags_match_jax():
    from tf_depth_estimation_tpu.train.experiments.common import base_parser

    ref = base_parser("jax").parse_args([])
    args = optflow_combine.parse_args([])
    for flag, _, _ in JAX_FLAGS:
        assert getattr(args, flag[2:]) == getattr(ref, flag[2:]), flag


def test_profile_step_runs_on_cpu():
    """The profiler breakdown's control flow at a small size; on the CPU it sees no
    device kernels."""
    from tf_depth_estimation_torch.train import profile_step

    out = profile_step.profile(steps=1, device="cpu", batch=2, height=32, width=64)
    assert out["wall_ms"] > 0 and out["kernel_ms"] == 0.0 and out["launches"] == 0
    assert profile_step.kind_of("(anonymous namespace)::bilinear_group_backward(Group)") == \
        "sampler kernels"
    assert profile_step.kind_of("(anonymous namespace)::smooth_backward_kernel(Plane)") == \
        "smoothness kernels"


def test_profile_step_runs_config_2_on_cpu():
    from tf_depth_estimation_torch.train import profile_step

    out = profile_step.profile(steps=1, device="cpu", batch=2, height=32, width=64,
                               config="depth_only")
    assert out["wall_ms"] > 0 and out["launches"] == 0
