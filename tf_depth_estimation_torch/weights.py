"""The weight bridge: JAX variables tree <-> the port's ``DispNet``, ``DepthPoseNet`` and
``TurboDepthNet`` state dicts.

A layer of the JAX tree (numpy arrays from a ``.npz`` or from a flax ``init``) is a node
holding ``Conv_0`` or ``TFConvTranspose_0`` (``kernel``, and ``bias`` for a linear head)
and, when a batch norm follows, ``BatchNorm_0/bias`` in ``params`` and
``BatchNorm_0/{mean,var}`` at the same path in ``batch_stats``. The state dict names each
layer by the same path joined with dots: ``DispNet``'s layers sit under the parts
``encoder``, ``decoder`` and, for depth10_flow, ``flow_decoder`` (``decoder.upcnv7``,
``flow_decoder.disp1_opt``), ``DepthPoseNet``'s and ``TurboDepthNet``'s at the top
(``cnv1``, ``exp_upcnv5``, ``pose_pred``; ``stem``, ``up1``, ``disp1``). Conv kernels are HWIO and become OIHW. TF transposed-conv kernels (the
``upcnv`` layers) are ``[kh, kw, out, in]`` and become ``conv_transpose2d``'s
``[in, out, kh, kw]``; both are the same axis permutation, and neither is flipped
(``models/layers.py`` says why).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant

_TO_TORCH = (3, 2, 0, 1)    # HWIO -> OIHW, and [kh, kw, out, in] -> [in, out, kh, kw]
_TO_JAX = (2, 3, 1, 0)
_CONVS = ("Conv_0", "TFConvTranspose_0")


def _layers(tree: Dict[str, Any], path=()):
    """(path, layer) of every layer node of a params tree, depth first."""
    for name, node in tree.items():
        if any(k in node for k in _CONVS):
            yield path + (name,), node
        else:
            yield from _layers(node, path + (name,))


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables tree -> state dict (float32 CPU tensors)."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd: Dict[str, torch.Tensor] = {}
    for path, layer in _layers(variables["params"]):
        key = ".".join(path)
        if "BatchNorm_0" not in layer:     # a linear head: conv + bias
            sd[f"{key}.weight"] = t(layer["Conv_0"]["kernel"]).permute(_TO_TORCH)
            sd[f"{key}.bias"] = t(layer["Conv_0"]["bias"])
            continue
        stats = variables["batch_stats"]
        for name in path:
            stats = stats[name]
        conv = layer.get("Conv_0") or layer["TFConvTranspose_0"]
        sd[f"{key}.conv.weight"] = t(conv["kernel"]).permute(_TO_TORCH)
        sd[f"{key}.bn.bias"] = t(layer["BatchNorm_0"]["bias"])
        sd[f"{key}.bn.running_mean"] = t(stats["BatchNorm_0"]["mean"])
        sd[f"{key}.bn.running_var"] = t(stats["BatchNorm_0"]["var"])
    return {k: v.contiguous() for k, v in sd.items()}


def state_dict_to_variables(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """State dict -> JAX variables tree of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    n = lambda v: v.detach().cpu().float().numpy()

    def node(tree, path):
        for name in path:
            tree = tree.setdefault(name, {})
        return tree

    for key, v in sd.items():
        parts = key.split(".")
        if parts[-2:] == ["conv", "weight"]:
            kind = "TFConvTranspose_0" if "upcnv" in parts[-3] else "Conv_0"
            node(params, parts[:-2])[kind] = {"kernel": n(v).transpose(_TO_JAX)}
        elif parts[-2:] == ["bn", "bias"]:
            node(params, parts[:-2])["BatchNorm_0"] = {"bias": n(v)}
        elif parts[-2] == "bn":
            field = {"running_mean": "mean", "running_var": "var"}[parts[-1]]
            node(stats, parts[:-2]).setdefault("BatchNorm_0", {})[field] = n(v)
        elif parts[-1] == "weight":
            node(params, parts[:-1]).setdefault("Conv_0", {})["kernel"] = \
                n(v).transpose(_TO_JAX)
        else:
            node(params, parts[:-1]).setdefault("Conv_0", {})["bias"] = n(v)
    return {"params": params, "batch_stats": stats}


def dispnet_from_variables(variables: Dict[str, Any], *, device="cuda") -> DispNet:
    """An eval-mode float32 ``DispNet`` on ``device`` holding ``variables`` (strict
    load): depth10_flow where the tree has a ``flow_decoder``, else depth4; the input
    channels are those of ``cnv1``'s kernel."""
    params = variables["params"]
    flow = "flow_decoder" in params
    model = DispNet(DispNetVariant.depth10_flow() if flow else DispNetVariant.depth4(),
                    in_channels=np.shape(params["encoder"]["cnv1"]["Conv_0"]["kernel"])[2])
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model.eval().to(device)


def depth_pose_from_variables(variables: Dict[str, Any], *, device="cuda") -> DepthPoseNet:
    """An eval-mode float32 ``DepthPoseNet`` on ``device`` holding ``variables`` (strict
    load): full resolution where the tree has ``disp1``, and as many sources as
    ``pose_pred`` has outputs / 6."""
    params = variables["params"]
    model = DepthPoseNet(full_resolution="disp1" in params,
                         num_source=np.shape(params["pose_pred"]["Conv_0"]["kernel"])[3] // 6)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model.eval().to(device)


def turbo_from_variables(variables: Dict[str, Any], variant: TurboVariant, *,
                         device="cuda") -> TurboDepthNet:
    """An eval-mode float32 ``TurboDepthNet(variant)`` on ``device`` holding ``variables``
    (strict load: a tree of another variant raises ``RuntimeError``)."""
    model = TurboDepthNet(variant)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model.eval().to(device)
