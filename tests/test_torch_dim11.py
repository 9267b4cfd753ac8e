"""``dim11`` in the port against the JAX package: the dim11 loader's batches, the
intrinsics helpers the CLI builds its pyramid with, and one float32 step of
``make_dim11_step`` (the full-resolution DepthPoseNet) from one init in both packages.
The loss itself, on shared predictions, and the CLI are in
``tests/test_torch_optflow_family.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from torch_fixtures import dim11_dataset, drop_tmp_path  # noqa: F401 (fixtures)
from tf_depth_estimation_torch.data.colon import Dim11Dataset
from tf_depth_estimation_torch.data.pipeline import BatchLoader
from tf_depth_estimation_torch.geometry.camera import (
    make_intrinsics_matrix,
    scale_intrinsics_pyramid,
)
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.train.experiments import dim11
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_dim11_step
from tf_depth_estimation_torch.utils.npz import _flatten
from tf_depth_estimation_torch.weights import state_dict_to_variables

H, W, B, LR = 32, 64, 2, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The file runs beside other pytest workers (tests/test_torch_split.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dim11_batches_match_jax(dim11_dataset):
    """Dim11Dataset + BatchLoader give JAX's batches for one seed (one worker): pixels in
    [-0.5, 0.5], the label from ``depth_dir``, the cam file's first 6 values, the
    projections; float32 rounding of the host resizes (tests/test_torch_train.py)."""
    from tf_depth_estimation_tpu.data.colon import Dim11Dataset as JDim11Dataset
    from tf_depth_estimation_tpu.data.pipeline import BatchLoader as JBatchLoader

    data, depth_dir = dim11_dataset
    kw = dict(image_height=H, image_width=W, resized_height=H, resized_width=W,
              depth_dir=depth_dir)
    ours = iter(BatchLoader(Dim11Dataset(data, **kw), B, seed=3, num_workers=1))
    ref = iter(JBatchLoader(JDim11Dataset(data, **kw), B, seed=3, num_workers=1))
    for _ in range(4):    # four batches of 2 from 4 train pairs: two epochs
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b) and "cam" in a and "intrinsics" not in a
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert a["tgt_image"].min() >= -0.5 and a["tgt_image"].max() <= 0.5
        assert (a["cam"][:, 1] > 0).all()   # fy from the 6-value file, not a 3x3 CSV


def test_intrinsics_helpers_match_jax():
    """``make_intrinsics_matrix`` and ``scale_intrinsics_pyramid`` (with resize ratios)
    against JAX's, bit for bit; and ``dim11.with_intrinsics`` builds the 4-scale pyramid
    of the cam files' fx fy cx cy."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.geometry import camera as jcamera

    rng = np.random.RandomState(0)
    cam = rng.uniform(10, 300, (3, 6)).astype(np.float32)
    K = make_intrinsics_matrix(*torch.from_numpy(cam[:, :4]).unbind(-1))
    jK = jcamera.make_intrinsics_matrix(*(jnp.asarray(cam[:, i]) for i in range(4)))
    np.testing.assert_array_equal(K.numpy(), np.asarray(jK))
    for ratios in ((1.0, 1.0), (0.5, 0.75)):
        np.testing.assert_array_equal(
            scale_intrinsics_pyramid(K, 4, *ratios).numpy(),
            np.asarray(jcamera.scale_intrinsics_pyramid(jK, 4, *ratios)))
    (b,) = dim11.with_intrinsics(iter([{"cam": cam.copy()}]))
    assert "cam" not in b and b["intrinsics"].shape == (3, 4, 3, 3)
    np.testing.assert_array_equal(b["intrinsics"],
                                  np.asarray(jcamera.scale_intrinsics_pyramid(jK, 4)))


@pytest.fixture(scope="module")
def dim11_step(dim11_dataset):
    """(the port's step, JAX's step, the init's params) of one float32 dim11 step of each
    package from the same init (a seeded port init of the full-resolution DepthPoseNet
    carried into JAX, as tests/test_torch_depth_then_cam.py does) and batch (the CLI's
    own loader, with its intrinsics pyramid); the port on its kernel-#4 preset (the plain
    sampler on the CPU), JAX on its "xla"."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet
    from tf_depth_estimation_tpu.train import steps as jsteps
    from tf_depth_estimation_tpu.train.state import TrainState, adam

    data, depth_dir = dim11_dataset
    init = state_dict_to_variables(DepthPoseNet(
        full_resolution=True, generator=torch.Generator().manual_seed(0)).state_dict())
    params = jax.tree.map(jnp.asarray, init["params"])
    tx = adam(LR)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, init["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=JDepthPoseNet(full_resolution=True).apply)
    args = dim11.parse_args(["--dataset_dir", data, "--depth_dir", depth_dir,
                             "--image_height", str(H), "--image_width", str(W),
                             "--batch_size", str(B), "--device", "cpu", "--seed", "4"])
    batch = next(dim11.batches(args))
    jw = dataclasses.replace(JLossWeights.dim11(), height=H, width=W)
    new, metrics = jax.jit(jsteps.make_dim11_step(jw))(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(jax.tree.map(np.asarray, new.params)),
           "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
    state = create_train_state(DepthPoseNet(full_resolution=True), learning_rate=LR)
    state.load_variables(init)
    w = dataclasses.replace(LossWeights.dim11(), height=H, width=W)
    assert w.sampler == "pallas" and jw.sampler == "xla"
    state, metrics = make_dim11_step(w)(state, batch)
    variables = state.variables()
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _flatten(variables["params"]),
           "batch_stats": _flatten(variables["batch_stats"]), "step": state.step}
    return got, ref, _flatten(init["params"])


def test_dim11_step_loss_components_match_jax(dim11_step):
    got, ref, _ = dim11_step
    assert sorted(got["metrics"]) == sorted(ref["metrics"]) and got["step"] == 1
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)


def test_dim11_step_batch_stats_match_jax(dim11_step):
    """Running statistics after the train forward, at tests/test_torch_split.py's
    tolerance for DepthPoseNet."""
    got, ref, _ = dim11_step
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_dim11_step_params_match_jax(dim11_step):
    """Every parameter within 2 lr of JAX's after Adam's first update, all but 1 % within
    1e-6 (tests/test_torch_train.py)."""
    got, ref, init = dim11_step
    assert sorted(got["params"]) == sorted(ref["params"])
    total = off = 0
    for k, v in ref["params"].items():
        assert np.abs(v - init[k]).max() <= LR * (1 + 1e-4), k
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * LR * (1 + 1e-4), k
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off / total < 0.01, (off, total)
