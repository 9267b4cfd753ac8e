"""Config-2 (depth_only) training in the port against the JAX package, and the smoothness
kernel pair: ``smoothness_fused`` on the CPU against JAX's (the Pallas kernel in
interpret mode) and the plain term, the backward's gather formula against autograd, one
float32 step and the validation components from a JAX init, and the CLI with in-loop
validation. The ``cuda`` tests hold the CUDA kernels to the plain version on the card.

JAX is imported inside the tests and fixtures that use it: the GPU machine has no JAX,
and runs the ``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader
from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
from tf_depth_estimation_torch.losses.basic import second_order_smoothness
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models import DispNet, DispNetVariant
from tf_depth_estimation_torch.ops import smoothness as sm
from tf_depth_estimation_torch.train.experiments import depth_only
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_only_step, make_depth_only_val_step
from tf_depth_estimation_torch.utils.npz import _flatten
from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)

H, W, B, LR = 64, 96, 2, 2e-4
# the limits of tests/test_pallas.py:69 for the smoothness kernel: value rtol 1e-5,
# gradient atol 1e-6 (the gradient's entries are ~1 / (B * count), 1e-5 to 1e-3 here)
TOL_VALUE = dict(rtol=1e-5)
TOL_GRAD = dict(rtol=0, atol=1e-6)


def _smooth_case(name, seed=0):
    """(base, view): a float32 torch tensor and the function that views it as the
    [B, H, W, C] map. "strided" is channel 1 of an NCHW [B, 2, H, W] tensor viewed NHWC,
    as config 4's flow heads reach the loss; the others are the map itself."""
    rng = np.random.RandomState(seed)
    if name == "strided":
        nchw = torch.from_numpy(rng.uniform(-2, 2, (2, 2, 24, 32)).astype(np.float32))
        return nchw, lambda t: t.permute(0, 2, 3, 1)[..., 1:2]
    arrays = {
        "random": lambda: rng.uniform(0.5, 2, (3, 24, 32, 1)),
        "constant": lambda: np.full((2, 16, 20, 1), 1.5),   # every term exactly 0
        # blocks of constants: exact zeros inside, steps at the edges, and ties of
        # |dxdy| and |dydx| of opposite first differences
        "piecewise": lambda: np.kron(rng.randint(0, 4, (2, 4, 5, 1)) * 0.25,
                                     np.ones((1, 6, 5, 1))),
        "odd": lambda: rng.uniform(0.5, 2, (2, 37, 53, 1)),
        "c2": lambda: rng.uniform(0.5, 2, (2, 12, 16, 2)),   # fallbacks: C != 1,
        "h2": lambda: rng.uniform(0.5, 2, (2, 2, 16, 1)),    # H < 3,
        "w2": lambda: rng.uniform(0.5, 2, (2, 12, 2, 1)),    # W < 3
    }
    return torch.from_numpy(arrays[name]().astype(np.float32)), lambda t: t


def _grad_of(fn, base, view):
    """(fn(view(base)), d/d map) with the gradient taken through the view."""
    base = base.detach().clone().requires_grad_(True)
    out = fn(view(base))
    out.backward()
    return out.detach(), view(base.grad)


KERNEL_CASES = ["random", "strided", "constant", "piecewise", "odd"]
FALLBACK_CASES = ["c2", "h2", "w2"]
TIES = ("constant", "piecewise")   # maps with terms exactly 0


def _jax_abs_derivative(t):
    """d|t|/dt as JAX takes it: +1 at t = 0 (lax's abs JVP selects on t >= 0)."""
    return torch.where(t >= 0, 1.0, -1.0)


@pytest.mark.parametrize("name", KERNEL_CASES + FALLBACK_CASES)
def test_smoothness_fused_matches_jax_kernel_and_plain_term(name):
    """The port's wrapper on the CPU against JAX's ``smoothness_fused`` (the Pallas kernel
    in interpret mode, or JAX's own fallback) and the plain term: the value everywhere,
    the gradient where no term is 0. At exact ties the port's gradient is autograd's
    (d|t|/dt = 0 at t = 0, as in PyTorch and TF1) and JAX's differs by its +1 there (the
    next test)."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.basic import second_order_smoothness as jsmooth
    from tf_depth_estimation_tpu.ops.pallas_losses import smoothness_fused as jfused

    base, view = _smooth_case(name)
    p = jnp.asarray(np.ascontiguousarray(view(base).numpy()))
    got, grad = _grad_of(sm.smoothness_fused, base, view)
    for fn in (lambda v: jfused(v, True), jsmooth):
        ref, ref_grad = jax.jit(jax.value_and_grad(fn))(p)
        np.testing.assert_allclose(got.item(), float(ref), **TOL_VALUE)
        if name not in TIES:
            np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), **TOL_GRAD)
    if name in TIES:
        _, plain = _grad_of(second_order_smoothness, base, view)
        np.testing.assert_allclose(grad.numpy(), plain.numpy(), **TOL_GRAD)


@pytest.mark.parametrize("name", TIES)
def test_jax_gradient_at_ties_is_the_gather_formula_with_its_abs_derivative(name):
    """JAX's gradient at ties is the backward's gather formula with JAX's d|t|/dt, so the
    two packages differ at ties by that convention alone."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_losses import smoothness_fused as jfused

    base, view = _smooth_case(name)
    ref = jax.jit(jax.grad(lambda v: jfused(v, True)))(jnp.asarray(view(base).numpy()))
    got = sm.smoothness_backward_reference(view(base), torch.tensor(1.0),
                                           sign=_jax_abs_derivative)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_GRAD)
    ours = sm.smoothness_backward_reference(view(base), torch.tensor(1.0))
    assert np.abs(ours.numpy() - np.asarray(ref)).max() > 1e-4   # the convention shows


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_backward_gather_formula_matches_autograd(name):
    """``smoothness_backward_reference``, the formula the CUDA backward computes, against
    autograd of the plain term, with a cotangent other than 1."""
    base, view = _smooth_case(name)
    ct = torch.tensor(0.7)
    _, ref = _grad_of(lambda m: second_order_smoothness(m) * ct, base, view)
    got = sm.smoothness_backward_reference(view(base), ct)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * ref.abs().max().item())


def test_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(TypeError):
        sm.smoothness_fused(torch.zeros(1, 8, 8, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        sm.smoothness_fused(torch.zeros(8, 8, 1))


# ---- config 2 against JAX ---------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colon"))
    return write_colon_pair_dataset(root, num_frames=6, H=H, W=W)


@pytest.fixture(scope="module")
def from_jax_init(dataset):
    """One float32 train step and one validation batch through each package, from one JAX
    ``create_train_state`` init of depth4 DispNet."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.train.state import create_train_state as jcreate
    from tf_depth_estimation_tpu.train.steps import make_depth_only_step as jstep
    from tf_depth_estimation_tpu.train.steps import make_depth_only_val_step as jval

    def first_batch(split, n):
        ds = PairDepthDataset(dataset, split=split, image_height=H, image_width=W,
                              resized_height=H, resized_width=W)
        return next(iter(BatchLoader(ds, n, num_workers=1)))

    batch, val_batch = first_batch("train", B), first_batch("val", 1)
    state = jcreate(JDispNet(JVariant.depth4(), dtype=jnp.float32),
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

    port = create_train_state(DispNet(DispNetVariant.depth4()), learning_rate=LR)
    port.load_variables(init)
    w = dataclasses.replace(LossWeights.depth_only(), height=H, width=W)
    val = make_depth_only_val_step(w)(port, {k: torch.from_numpy(v)
                                             for k, v in val_batch.items()})
    port, metrics = make_depth_only_step(w)(port, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    variables = port.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "val": {k: float(v) for k, v in val.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": port.step}
    return got, ref, _flatten(init["params"])


def test_one_step_loss_components_match_jax(from_jax_init):
    got, ref, _ = from_jax_init
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) == ["depth", "smooth", "total"]
    assert got["step"] == 1
    for k, v in ref["metrics"].items():   # the same forward, sums in another order
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_one_step_batch_stats_match_jax(from_jax_init):
    """Running statistics after the train forward, 0.99 * init + 0.01 * batch for depth4;
    the tolerance of tests/test_torch_train.py (biased fast variance of 0-255 inputs)."""
    got, ref, _ = from_jax_init
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_one_step_params_match_jax(from_jax_init):
    """Adam's first step, held as tests/test_torch_train.py holds config 4's: every
    parameter within 2 lr of JAX's, all but 1 % within 1e-6 (a float32 gradient below its
    own rounding error can flip its sign, and the parameter moves lr the other way)."""
    got, ref, init = from_jax_init
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)


def test_val_components_match_jax(from_jax_init):
    """The eval forward (running statistics) and ``depth_only_val_loss`` on one validation
    pair, from the same init: si-log-RMSE and smoothness at the loss tolerance."""
    got, ref, _ = from_jax_init
    assert sorted(got["val"]) == sorted(ref["val"]) == ["si_log_rmse", "smooth", "total"]
    for k, v in ref["val"].items():
        np.testing.assert_allclose(got["val"][k], v, rtol=1e-5, err_msg=k)


def test_cli_trains_with_in_loop_validation(dataset, tmp_path):
    """3 float32 steps on the CPU with ``--validation_check 2``: a val record at step 2,
    every record finite, and the checkpoint back into depth4 DispNet."""
    ckpt = str(tmp_path / "ckpt")
    state, last = depth_only.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "3",
        "--summary_freq", "1", "--validation_check", "2", "--device", "cpu",
        "--dtype", "float32"])
    assert state.step == 3 and all(np.isfinite(v) for v in last.values())
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [(r["step"], r["scope"]) for r in records] == [
        (1, "train"), (2, "train"), (2, "val"), (3, "train")]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k != "scope")
    assert sorted(records[2]) == ["scope", "si_log_rmse", "smooth", "step", "total"]
    from tf_depth_estimation_torch.utils.npz import load_variables_npz
    from tf_depth_estimation_torch.weights import dispnet_from_variables

    model = dispnet_from_variables(load_variables_npz(os.path.join(ckpt, "model-3.npz"))[0],
                                   device="cpu")
    assert model.variant.name == "depth4"


def test_validation_without_a_val_split_gives_none(dataset, tmp_path):
    """A dataset without ``val.txt`` trains without validation (JAX
    ``depth_only.py:69-76``): the CLI's ``val_fn`` returns None, which the loop logs as
    nothing, at every call."""
    for name in os.listdir(dataset):
        if name != "val.txt":
            os.symlink(os.path.join(dataset, name), tmp_path / name)
    args = depth_only.parse_args(["--dataset_dir", str(tmp_path), "--device", "cpu",
                                  "--image_height", str(H), "--image_width", str(W)])
    val_fn = depth_only.validation(args, LossWeights.depth_only())
    assert val_fn(None) is None and val_fn(None) is None


def test_cli_takes_turbo_presets(tmp_path):
    """``--turbo colon`` is accepted."""
    argv = ["--dataset_dir", str(tmp_path), "--turbo", "colon"]
    assert depth_only.parse_args(argv).turbo == "colon"


def test_cli_refuses_turbo(tmp_path, capsys):
    """An unknown ``--turbo`` preset is refused with ``TurboVariant.by_name``'s error."""
    with pytest.raises(SystemExit):
        depth_only.parse_args(["--dataset_dir", str(tmp_path), "--turbo", "colossal"])
    assert "unknown turbo variant 'colossal'" in capsys.readouterr().err


# ---- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_cuda_kernels_match_plain_version(name):
    """Forward within rtol 1e-5 of the plain term (float32 and float64), the same bits in
    two runs, one launch each way a call (a group of one), and the backward within 1e-6
    max|g| of autograd."""
    dev = _cuda()
    base, view = _smooth_case(name)
    base = base.to(dev)
    x = view(base)
    before = (sm.smoothness_fused.launches, sm.smoothness_fused.backward_launches)
    got, grad = _grad_of(sm.smoothness_fused, base, view)
    again = sm.smoothness_fused(x)
    torch.cuda.synchronize()
    assert (sm.smoothness_fused.launches - before[0],
            sm.smoothness_fused.backward_launches - before[1]) == (2, 1)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.item(), second_order_smoothness(x).item(), **TOL_VALUE)
    np.testing.assert_allclose(got.item(), second_order_smoothness(x.double()).item(),
                               **TOL_VALUE)
    _, ref = _grad_of(second_order_smoothness, base, view)
    torch.testing.assert_close(grad, ref, rtol=0, atol=1e-6 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", FALLBACK_CASES)
def test_cuda_fallbacks_launch_nothing(name):
    dev = _cuda()
    base, view = _smooth_case(name)
    x = view(base.to(dev))
    before = sm.smoothness_fused.launches
    np.testing.assert_allclose(sm.smoothness_fused(x).item(),
                               second_order_smoothness(x).item(), rtol=0)
    assert sm.smoothness_fused.launches == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_dtypes():
    dev = _cuda()
    with pytest.raises(TypeError):
        sm.smoothness_fused(_smooth_case("random")[0].to(dev, torch.bfloat16))


@pytest.mark.cuda
def test_cuda_depth_only_step_launches_four_each_way():
    """One float32 config-2 step at 64x96 on the card: its four smoothness terms in one
    forward and one backward launch, and a validation's in one forward launch."""
    dev = _cuda()
    rng = np.random.RandomState(0)
    batch = {"tgt_image": torch.from_numpy(rng.uniform(0, 255, (B, H, W, 3)).astype(
        np.float32)).to(dev), "label": torch.from_numpy(rng.uniform(
            0.5, 3, (B, H, W, 1)).astype(np.float32)).to(dev)}
    w = dataclasses.replace(LossWeights.depth_only(), height=H, width=W)
    state = create_train_state(DispNet(DispNetVariant.depth4(),
                                       generator=torch.Generator().manual_seed(0)).to(dev))
    sm.smoothness_fused.launches = sm.smoothness_fused.backward_launches = 0
    _, metrics = make_depth_only_step(w)(state, batch)
    assert (sm.smoothness_fused.launches, sm.smoothness_fused.backward_launches) == (1, 1)
    val = make_depth_only_val_step(w)(state, {k: v[:1] for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (sm.smoothness_fused.launches, sm.smoothness_fused.backward_launches) == (2, 1)
    assert all(bool(torch.isfinite(v)) for v in (*metrics.values(), *val.values()))
