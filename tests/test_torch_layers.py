"""Port layers (TF SAME conv, TF transposed conv, eval slim BN) against the JAX layers."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf_depth_estimation_tpu.models.layers import SlimConv as JSlimConv
from tf_depth_estimation_tpu.models.layers import TFConvTranspose as JTFConvTranspose
from tf_depth_estimation_torch.models import layers

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 convs: the same products summed in another order


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [(12, 16), (11, 15)])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (7, 1), (7, 2)])
def test_conv2d_same_matches_tf_same(hw, k, stride):
    x, w = _rand((2, *hw, 5), 0), _rand((k, k, 5, 6), 1)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                                       "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = layers.conv2d_same(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                             stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


def test_symmetric_padding_would_shift_7x7_s2():
    """TF pads 2 on top and 3 below at 7x7/s2 on an even size; padding=3 is off by one."""
    x, w = _rand((1, 12, 16, 3), 2), _rand((7, 7, 3, 4), 3)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    ours = layers.conv2d_same(_nchw(x), wt, stride=2)
    naive = F.conv2d(_nchw(x), wt, stride=2, padding=3)
    assert ours.shape == naive.shape
    assert not torch.allclose(ours, naive, atol=1e-3)


@pytest.mark.parametrize("hw", [(5, 7), (6, 8), (1, 3)])
def test_tf_conv_transpose_matches_jax(hw):
    x = _rand((2, *hw, 8), 4)
    mod = JTFConvTranspose(features=6, kernel=(3, 3))
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))
    port = layers.TFConvTranspose(8, 6)
    with torch.no_grad():   # [kh, kw, out, in] -> [in, out, kh, kw], no flip
        port.weight.copy_(torch.from_numpy(
            np.array(variables["params"]["kernel"])).permute(3, 2, 0, 1))
        got = port(_nchw(x))
    assert got.shape[-2:] == (2 * hw[0], 2 * hw[1])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k", [4, 5, 7])
def test_tf_conv_transpose_larger_kernels_match_jax(k):
    """DepthPoseNet's explainability decoder has 5x5 and 7x7 transposed convs: the SAME
    crop starts (k - 2) // 2 rows and columns in (ROADMAP Queue 3); a crop from 0, right
    for 3x3, shifts the output by a pixel or two."""
    x = _rand((2, 5, 7, 8), 5)
    mod = JTFConvTranspose(features=6, kernel=(k, k))
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))
    port = layers.TFConvTranspose(8, 6, k)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.array(variables["params"]["kernel"])).permute(3, 2, 0, 1))
        got = port(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_slim_conv_eval_bn_matches_jax(transpose):
    """conv -> eval BN (eps 1e-3, no scale) -> ReLU with non-trivial running stats."""
    x = _rand((2, 6, 10, 4), 5)
    mod = JSlimConv(features=7, kernel=(3, 3), stride=2 if transpose else 1,
                    transpose=transpose)
    variables = jax.tree.map(np.array, mod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                                  train=False))
    rng = np.random.RandomState(6)
    bn = variables["batch_stats"]["BatchNorm_0"]
    bn["mean"] = rng.randn(7).astype(np.float32)
    bn["var"] = rng.rand(7).astype(np.float32) + 0.1
    variables["params"]["BatchNorm_0"]["bias"] = rng.randn(7).astype(np.float32)
    ref = mod.apply(variables, jnp.asarray(x), train=False)

    port = layers.SlimConv(4, 7, 3, 2 if transpose else 1, transpose=transpose).eval()
    kind = "TFConvTranspose_0" if transpose else "Conv_0"
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(
            variables["params"][kind]["kernel"]).permute(3, 2, 0, 1))
        port.bn.bias.copy_(torch.from_numpy(variables["params"]["BatchNorm_0"]["bias"]))
        port.bn.running_mean.copy_(torch.from_numpy(bn["mean"]))
        port.bn.running_var.copy_(torch.from_numpy(bn["var"]))
        got = port(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


def test_eval_bn_matches_flax_batchnorm():
    x = _rand((3, 4, 5, 6), 7)
    rng = np.random.RandomState(8)
    mean, var, bias = rng.randn(6), rng.rand(6) + 0.05, rng.randn(6)
    bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-3, use_scale=False)
    ref = bn.apply({"params": {"bias": bias}, "batch_stats": {"mean": mean, "var": var}},
                   jnp.asarray(x))
    port = layers.SlimBatchNorm(6).eval()
    with torch.no_grad():
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
        got = port(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


def test_train_mode_bn_is_refused():
    """Train-mode batch norm refuses an empty batch, whose statistics would write NaN
    into the running mean and variance."""
    with pytest.raises(ValueError):
        layers.SlimBatchNorm(3).train()(torch.zeros(0, 3, 2, 2))


@pytest.mark.parametrize("momentum", [0.99, 0.999])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_bn_matches_flax_batchnorm(momentum, dtype):
    """Batch statistics (biased "fast" variance in float32), the output in the input's
    dtype, and the running statistics after one forward, ``m * r + (1 - m) * batch``."""
    x = _rand((4, 5, 6, 7), 9) * 3.0 + 1.5
    rng = np.random.RandomState(10)
    mean, var, bias = (rng.randn(7).astype(np.float32), rng.rand(7).astype(np.float32) + .5,
                       rng.randn(7).astype(np.float32))
    jdt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3,
                       use_scale=False, dtype=jdt)
    ref, mut = bn.apply({"params": {"bias": bias},
                         "batch_stats": {"mean": mean, "var": var}},
                        jnp.asarray(x).astype(jdt), mutable=["batch_stats"])
    port = layers.SlimBatchNorm(7, momentum).train()
    with torch.no_grad():
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
    got = port(_nchw(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same float32 value rounded once to bf16, unless the two float32 results
    # straddle a rounding boundary (one bf16 step, 2^-8 relative)
    tol = TOL if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-6, atol=1e-6)


def test_glorot_init_uses_flax_fans():
    """Each kernel of the port's init is uniform within the bound that flax's
    glorot_uniform gives the JAX variable of the same layer: sqrt(6 / (fan_in +
    fan_out)), with the fans of [k, k, in, out] (conv) or [k, k, out, in] (TF deconv)."""
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_torch.models import DispNet, DispNetVariant

    variables = JDispNet(JVariant.depth10_flow()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)), train=False)
    net = DispNet(DispNetVariant.depth10_flow(), generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        keys = [p.key for p in path]
        if keys[-1] != "kernel":
            continue
        k = np.asarray(leaf)
        bound = (6.0 / ((k.shape[2] + k.shape[3]) * k.shape[0] * k.shape[1])) ** 0.5
        name = f"{keys[0]}.{keys[1]}" + ("" if keys[1].startswith("disp") else ".conv")
        w = sd[f"{name}.weight"]
        assert w.shape == torch.Size(np.transpose(k, (3, 2, 0, 1)).shape), name
        for got in (w.abs().max().item(), float(np.abs(k).max())):
            assert 0.9 * bound < got <= bound * (1 + 1e-6), (name, got, bound)
        n += 1
    assert n == 14 + 2 * (7 + 7 + 4)   # encoder; each decoder's deconvs, iconvs, heads
