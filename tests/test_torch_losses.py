"""The port's loss terms and ``optflow_combine_loss`` against the JAX package's, in value
and in gradient with respect to the predictions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.losses import basic as jbasic
from tf_depth_estimation_tpu.losses import pipelines as jpipelines
from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
from tf_depth_estimation_torch.data.synthetic import make_pair_scene, pose_matrix
from tf_depth_estimation_torch.losses import basic, pipelines
from tf_depth_estimation_torch.losses.config import LossWeights

H, W, B = 32, 64, 2
# float32: sums over the pyramid in another order; the photometric terms sample [0, 255]
# images at coordinates that agree to ~1e-5 (tests/test_torch_geometry.py)
TOL_LOSS = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-6)


def test_loss_weights_tables_match():
    for name in ("depth_only", "optflow_combine", "optflow_only", "split_training",
                 "gtdepth_gtcam", "dim11"):
        got = dataclasses.asdict(getattr(LossWeights, name)())
        ref = dataclasses.asdict(getattr(JLossWeights, name)())
        if name in ("gtdepth_gtcam", "dim11"):  # their warps run the port's sampler kernels
            assert (got.pop("sampler"), ref.pop("sampler")) == ("pallas", "xla")
        assert got == ref, name
    assert LossWeights.optflow_combine().scale_hw(3) == (28, 60)


@pytest.mark.parametrize("shape", [(2, 9, 11, 2), (1, 3, 3, 1), (2, 28, 60, 1)])
def test_second_order_smoothness(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    np.testing.assert_allclose(basic.second_order_smoothness(torch.from_numpy(x)).item(),
                               float(jbasic.second_order_smoothness(jnp.asarray(x))),
                               rtol=1e-6)


def _batch(seed=0):
    """A config-4 batch at 32x64 from synthetic scenes and predictions near the label."""
    rng = np.random.RandomState(seed)
    scenes = [make_pair_scene(rng, H, W) for _ in range(B)]
    tgt, src, depth, K, pose6 = (np.stack(a) for a in zip(*scenes))
    K4 = np.array([[[[k[0, 0] / 2**s, 0, k[0, 2] / 2**s], [0, k[1, 1] / 2**s, k[1, 2] / 2**s],
                     [0, 0, 1]] for s in range(4)] for k in K], np.float32)
    batch = {"tgt_image": tgt, "src_image": src, "label": depth[..., None],
             "intrinsics": K4, "proj": np.stack([pose_matrix(p) for p in pose6])}
    preds = {
        "depths": [(depth[:, ::2**s, ::2**s, None] * rng.uniform(0.7, 1.3, (B, H >> s,
                    W >> s, 1))).astype(np.float32) for s in range(4)],
        "fx": [rng.randn(B, H >> s, W >> s, 1).astype(np.float32) for s in range(4)],
        "fy": [rng.randn(B, H >> s, W >> s, 1).astype(np.float32) for s in range(4)]}
    return batch, preds


def _jax_loss(batch, preds, w):
    def f(p):
        return jpipelines.optflow_combine_loss(
            batch["tgt_image"], batch["src_image"], p["depths"], p["fx"], p["fy"],
            batch["label"], batch["proj"], batch["intrinsics"], w)
    (_, comps), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, preds))
    return comps, grads


@pytest.mark.parametrize("sampler", ["pallas", "xla"])
def test_optflow_combine_loss_and_gradients_match_jax(sampler):
    batch, preds = _batch()
    jw = dataclasses.replace(JLossWeights.optflow_combine(), height=H, width=W)
    ref_comps, ref_grads = _jax_loss(batch, preds, jw)

    w = dataclasses.replace(LossWeights.optflow_combine(), height=H, width=W,
                            sampler=sampler)
    tp = {k: [torch.from_numpy(a).requires_grad_(True) for a in v] for k, v in preds.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, comps = pipelines.optflow_combine_loss(
        tb["tgt_image"], tb["src_image"], tp["depths"], tp["fx"], tp["fy"], tb["label"],
        tb["proj"], tb["intrinsics"], w)
    total.backward()
    assert sorted(comps) == sorted(ref_comps)
    for k in comps:
        np.testing.assert_allclose(comps[k].item(), float(ref_comps[k]), **TOL_LOSS,
                                   err_msg=k)
    for k in tp:
        for s, (t, r) in enumerate(zip(tp[k], ref_grads[k])):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL_GRAD,
                                       err_msg=f"{k}[{s}]")


def test_si_log_rmse_matches_jax():
    """The reference's metric with its ``+ mean(d)**2``, on positive depths."""
    rng = np.random.RandomState(1)
    label, pred = (rng.uniform(0.4, 3.75, (2, 16, 24, 1)).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(
        basic.si_log_rmse(torch.from_numpy(label), torch.from_numpy(pred)).item(),
        float(jbasic.si_log_rmse(jnp.asarray(label), jnp.asarray(pred))), rtol=1e-6)


@pytest.mark.parametrize("name", ["depth_only_loss", "depth_only_val_loss"])
def test_depth_only_losses_and_gradients_match_jax(name):
    """Config 2's train and validation losses on the depth pyramid of ``_batch``, in
    value and in gradient with respect to the predictions."""
    batch, preds = _batch(seed=1)
    jw = dataclasses.replace(JLossWeights.depth_only(), height=H, width=W)
    (_, ref_comps), ref_grads = jax.value_and_grad(
        lambda p: getattr(jpipelines, name)(p, jnp.asarray(batch["label"]), jw),
        has_aux=True)([jnp.asarray(a) for a in preds["depths"]])
    w = dataclasses.replace(LossWeights.depth_only(), height=H, width=W)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in preds["depths"]]
    total, comps = getattr(pipelines, name)(tp, torch.from_numpy(batch["label"]), w)
    total.backward()
    assert sorted(comps) == sorted(ref_comps)
    for k in comps:
        np.testing.assert_allclose(comps[k].item(), float(ref_comps[k]), **TOL_LOSS,
                                   err_msg=k)
    for s, (t, r) in enumerate(zip(tp, ref_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL_GRAD,
                                   err_msg=f"depths[{s}]")
