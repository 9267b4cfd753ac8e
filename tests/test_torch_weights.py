"""Port weight files and the weight bridge against the JAX package's npz format."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.models import DispNet as JDispNet, DispNetVariant as JVariant
from tf_depth_estimation_tpu.train import checkpoint as jckpt
from tf_depth_estimation_torch.models import DispNet
from tf_depth_estimation_torch.utils import npz
from tf_depth_estimation_torch.weights import (
    dispnet_from_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = sorted(glob.glob(os.path.join(ROOT, "weights", "*.npz")))
TEACHER = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")


def _assert_trees_equal(a, b):
    fa, fb = npz._flatten(a), npz._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_all_nine_weight_files_present():
    assert len(WEIGHTS) == 9


@pytest.mark.parametrize("path", WEIGHTS, ids=os.path.basename)
def test_npz_load_matches_jax_loader(path):
    got, got_meta = npz.load_variables_npz(path)
    ref, ref_meta = jckpt.load_variables_npz(path)
    assert got_meta == ref_meta
    assert sorted(got) == sorted(ref)
    _assert_trees_equal(got, ref)


def test_teacher_bridge_round_trip():
    variables, _ = npz.load_variables_npz(TEACHER)
    sd = variables_to_state_dict(variables)
    model = DispNet()
    model.load_state_dict(sd, strict=True)   # every key and shape of the module
    _assert_trees_equal(state_dict_to_variables(model.state_dict()), variables)


def test_bridge_round_trip_from_jax_init():
    model = JDispNet(JVariant.depth4(), dtype=jnp.float32)
    x = jnp.zeros((1, 32, 48, 3), jnp.float32)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), x, train=False))
    net = dispnet_from_variables(variables, device="cpu")
    _assert_trees_equal(state_dict_to_variables(net.state_dict()), variables)


def test_bridge_layouts():
    """HWIO -> OIHW for convs, [kh,kw,out,in] -> [in,out,kh,kw] for deconvs, no flips."""
    variables, _ = npz.load_variables_npz(TEACHER)
    sd = variables_to_state_dict(variables)
    k = variables["params"]["encoder"]["cnv2"]["Conv_0"]["kernel"]       # (5,5,32,64)
    np.testing.assert_array_equal(sd["encoder.cnv2.conv.weight"][7, 3, 1, 4].item(),
                                  k[1, 4, 3, 7])
    d = variables["params"]["decoder"]["upcnv3"]["TFConvTranspose_0"]["kernel"]  # (3,3,64,128)
    np.testing.assert_array_equal(sd["decoder.upcnv3.conv.weight"][100, 9, 2, 0].item(),
                                  d[2, 0, 9, 100])


def _small_tree(rng):
    return {"params": {"a": {"Conv_0": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32)}},
                       "b": {"bias": rng.randn(5).astype(np.float32)}},
            "batch_stats": {}}


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_save_load_round_trip(tmp_path, writer, reader):
    tree = _small_tree(np.random.RandomState(0))
    save = npz.save_variables_npz if writer == "torch" else jckpt.save_variables_npz
    load = npz.load_variables_npz if reader == "torch" else jckpt.load_variables_npz
    path = str(tmp_path / "w.npz")
    save(path, tree, variant="nano", step=12)
    got, meta = load(path)
    assert meta == {"variant": "nano", "step": "12"}
    assert got["batch_stats"] == {}            # an empty collection comes back as {}
    _assert_trees_equal(got, tree)


def test_save_rejects_non_float(tmp_path):
    with pytest.raises(TypeError):
        npz.save_variables_npz(str(tmp_path / "w.npz"),
                               {"params": {"n": np.arange(3)}})


def test_state_dict_from_torch_tensors_survives_round_trip():
    sd = DispNet(generator=torch.Generator().manual_seed(0)).state_dict()
    back = variables_to_state_dict(state_dict_to_variables(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
