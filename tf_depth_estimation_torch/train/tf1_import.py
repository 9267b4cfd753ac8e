"""The TF1 checkpoint importer: reference-trained weights into the port; the port of
``tf_depth_estimation_tpu/train/tf1_import.py``.

The reference's inference and refinement scripts restore TF1 slim checkpoints by variable
scope (``batch_prediction.py:49-55``; ``split_training.py:147,338`` save the
``model_pairdepth`` / ``model_singledepth`` scopes). This maps those variables onto the
port's variables tree (the JAX layout of ``weights.py``, which ``load_variables``,
``DepthPredictor`` and the ``.npz`` files take) of depth4 DispNet or DepthPoseNet.

Slim name -> tree path (``depth_net``: ``nets_optflow_depth.py:80``; ``depth_cam_net``:
``:156``)::

    depth_net/cnv1/weights                -> params/encoder/cnv1/Conv_0/kernel
    depth_net/cnv1/BatchNorm/beta         -> params/encoder/cnv1/BatchNorm_0/bias
    depth_net/cnv1/BatchNorm/moving_mean  -> batch_stats/encoder/cnv1/BatchNorm_0/mean
    depth_net/upcnv7/weights              -> params/decoder/upcnv7/TFConvTranspose_0/kernel
    depth_net/disp4/{weights,biases}      -> params/decoder/disp4/Conv_0/{kernel,bias}
    depth_cam_net/pose/cam_cnv7/...       -> params/pose_cam_cnv7/...
    depth_cam_net/pose/pred/...           -> params/pose_pred/...
    depth_cam_net/exp/exp_upcnv5/...      -> params/exp_upcnv5/...
    depth_cam_net/exp/mask4/...           -> params/mask4/...

Layouts carry over as they are: slim ``conv2d`` weights are ``[k, k, in, out]`` and slim
``conv2d_transpose`` weights ``[k, k, out, in]``, the tree's own layouts. Reading a TF1
checkpoint needs TensorFlow (imported only there); ``import_tf1_variables`` takes any dict
of arrays. ::

    python -m tf_depth_estimation_torch.train.tf1_import CKPT_PREFIX --arch depth_pose \\
        --scope model_pairdepth/depth_cam_net --out C --group model_pairdepth

writes ``C/model_pairdepth-0.npz``, which ``train/checkpoint.py:load_latest_variables``
and ``infer/cli.py --checkpoint_dir C --checkpoint_group model_pairdepth`` read.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Tuple

import numpy as np

Path = Tuple[str, ...]


def read_tf1_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF1-format checkpoint (the V2 file layout) as numpy arrays."""
    import tensorflow as tf  # the importer's only use of TensorFlow

    reader = tf.train.load_checkpoint(prefix)
    return {name: np.asarray(reader.get_tensor(name))
            for name in reader.get_variable_to_shape_map()}


def _tf1_layer_name(layer: str, arch: str) -> str:
    """The tree's layer name -> its slim sub-scope path."""
    if arch == "depth_pose":
        if layer == "pose_cam_cnv7":
            return "pose/cam_cnv7"
        if layer == "pose_pred":
            return "pose/pred"
        if layer.startswith("exp_upcnv") or layer.startswith("mask"):
            return f"exp/{layer}"
    return layer


def tf1_name_for(path: Path, arch: str, scope: str) -> str:
    """The TF1 variable name of one tree path (collection first), e.g.
    ``('params', 'encoder', 'cnv1', 'Conv_0', 'kernel')``."""
    collection, *rest = path
    *mods, module, leaf = rest
    # DispNet nests its layers under encoder / decoder, slim keeps them flat in one
    # scope; the flow decoder's layers take '_opt' there (nets_depth.py)
    layer = _tf1_layer_name(mods[-1], arch)
    if "flow_decoder" in mods:
        layer = layer if layer.endswith("_opt") else f"{layer}_opt"
    if module in ("Conv_0", "TFConvTranspose_0"):
        return f"{scope}/{layer}/{'weights' if leaf == 'kernel' else 'biases'}"
    if module == "BatchNorm_0":
        if collection == "params":  # center only: beta
            return f"{scope}/{layer}/BatchNorm/beta"
        var = {"mean": "moving_mean", "var": "moving_variance"}[leaf]
        return f"{scope}/{layer}/BatchNorm/{var}"
    raise KeyError(f"unmapped tree path {path}")


def _leaves(tree: Dict[str, Any], path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) of a nested dict, keys sorted at every level (the order in which JAX
    flattens a dict)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]
    return out


def _unflatten(pairs: List[Tuple[Path, Any]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def import_tf1_variables(tf1_vars: Dict[str, np.ndarray], variables: Dict[str, Any],
                         arch: str, scope: str) -> Tuple[Dict[str, Any], List[Path]]:
    """Fill a variables tree (e.g. ``weights.module_variables(model)``) from TF1 variables,
    every leaf checked for its name and shape. ``arch``: 'dispnet' (scope ``depth_net``)
    or 'depth_pose' (``depth_cam_net``); ``scope`` includes any outer training scope
    (``model_pairdepth/depth_cam_net``). Returns (the filled tree, its paths in order)."""
    filled, paths = [], []
    for path, leaf in _leaves(variables):
        name = tf1_name_for(path, arch, scope)
        if name not in tf1_vars:
            raise KeyError(f"{name} (for {'/'.join(path)}) not in the checkpoint")
        value = np.asarray(tf1_vars[name])
        if tuple(value.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{name}: shape {value.shape} != the tree's {np.shape(leaf)}")
        filled.append((path, value.astype(np.asarray(leaf).dtype)))
        paths.append(path)
    return _unflatten(filled), paths


def init_variables(arch: str) -> Dict[str, Any]:
    """The variables tree of a seeded depth4 DispNet ('dispnet') or truncated DepthPoseNet
    ('depth_pose'), the model ``main`` imports into."""
    import torch

    from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
    from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
    from tf_depth_estimation_torch.weights import module_variables

    g = torch.Generator().manual_seed(0)
    model = (DispNet(DispNetVariant.depth4(), generator=g) if arch == "dispnet"
             else DepthPoseNet(generator=g))
    return module_variables(model)


def import_tf1_checkpoint(prefix: str, variables: Dict[str, Any], arch: str,
                          scope: str = None) -> Dict[str, Any]:
    """Read a TF1 checkpoint and fill ``variables`` from it (``scope`` defaults to the
    architecture's own)."""
    if scope is None:
        scope = "depth_net" if arch == "dispnet" else "depth_cam_net"
    tree, _ = import_tf1_variables(read_tf1_checkpoint(prefix), variables, arch, scope)
    return tree


def main(argv=None) -> str:
    from tf_depth_estimation_torch.utils.npz import save_variables_npz

    ap = argparse.ArgumentParser(description="TF1 checkpoint -> the port's checkpoint "
                                             "directory")
    ap.add_argument("prefix", help="TF1 checkpoint prefix (as for tf.train.Saver)")
    ap.add_argument("--arch", choices=["dispnet", "depth_pose"], required=True)
    ap.add_argument("--scope", default=None,
                    help="full TF variable scope (e.g. model_pairdepth/depth_cam_net)")
    ap.add_argument("--out", required=True, help="checkpoint directory")
    ap.add_argument("--group", default="model", help="checkpoint group")
    # the JAX converter sized its init by these; the port's init needs no input size
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    args = ap.parse_args(argv)
    tree = import_tf1_checkpoint(args.prefix, init_variables(args.arch), args.arch,
                                 args.scope)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.group}-0.npz")
    save_variables_npz(path, tree, step=0)
    print(f"imported {args.prefix} -> {path}")
    return path


if __name__ == "__main__":
    main()
