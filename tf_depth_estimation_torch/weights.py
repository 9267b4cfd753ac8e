"""The weight bridge: JAX variables tree <-> the port's ``DispNet``, ``DepthPoseNet``,
``PoseExpNet``, ``UpconvNet`` and ``TurboDepthNet`` state dicts, and ``LRNet``'s, whose two
submodules hold the ``single/...`` and ``pair/...`` trees.

A layer of the JAX tree (numpy arrays from a ``.npz`` or from a flax ``init``) is a node
holding ``Conv_0`` or ``TFConvTranspose_0`` (``kernel``, and ``bias`` where no batch norm
follows) and, when a batch norm follows, ``BatchNorm_0/bias`` in ``params`` and
``BatchNorm_0/{mean,var}`` at the same path in ``batch_stats``. A layer without a batch
norm is a linear head (``<layer>.weight``, ``<layer>.bias``) or, in depth4_nobn DispNet,
a conv + bias + ReLU (``SlimConv(use_bn=False)``: ``<layer>.conv.weight``,
``<layer>.conv.bias``); the tree does not tell them apart, so ``load_variables`` asks the
model's own keys. The state dict names each
layer by the same path joined with dots: ``DispNet``'s layers sit under the parts
``encoder``, ``decoder`` and, for depth10_flow, ``flow_decoder`` (``decoder.upcnv7``,
``flow_decoder.disp1_opt``), ``DepthPoseNet``'s and ``TurboDepthNet``'s at the top
(``cnv1``, ``exp_upcnv5``, ``pose_pred``; ``stem``, ``up1``, ``disp1``). Conv kernels are HWIO and become OIHW. TF transposed-conv kernels (the
``upcnv`` layers) are ``[kh, kw, out, in]`` and become ``conv_transpose2d``'s
``[in, out, kh, kw]``; both are the same axis permutation, and neither is flipped
(``models/layers.py`` says why). A state dict alone does not say which convs are
transposed: ``state_dict_to_variables`` takes the layers named ``upcnv`` as transposed
unless told, and ``module_variables`` tells it from the module (``UpconvNet``'s ``upcnv``
laterals are plain 1x1 convs).
"""
from __future__ import annotations

from typing import Any, Collection, Dict, Iterable, Optional

import numpy as np
import torch

from tf_depth_estimation_torch.models.composite import LRNet
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet, PoseExpNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.layers import TFConvTranspose
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.models.upconv import UpconvNet

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


def variables_to_state_dict(variables: Dict[str, Any],
                            keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """JAX variables tree -> state dict (float32 CPU tensors). A layer without a batch
    norm becomes ``<layer>.conv.weight`` / ``.conv.bias`` where ``keys`` (the keys of the
    state dict it is loaded into) hold ``<layer>.conv.weight``, else a linear head's
    ``<layer>.weight`` / ``.bias``. Models load through ``load_variables``, which passes
    their keys; without ``keys`` a depth4_nobn tree maps as linear heads."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    keys = set(keys or ())
    sd: Dict[str, torch.Tensor] = {}
    for path, layer in _layers(variables["params"]):
        key = ".".join(path)
        conv = layer.get("Conv_0") or layer["TFConvTranspose_0"]
        if "BatchNorm_0" not in layer:     # a linear head, or a conv + bias + ReLU
            pre = f"{key}.conv" if f"{key}.conv.weight" in keys else key
            sd[f"{pre}.weight"] = t(conv["kernel"]).permute(_TO_TORCH)
            sd[f"{pre}.bias"] = t(conv["bias"])
            continue
        stats = variables["batch_stats"]
        for name in path:
            stats = stats[name]
        sd[f"{key}.conv.weight"] = t(conv["kernel"]).permute(_TO_TORCH)
        sd[f"{key}.bn.bias"] = t(layer["BatchNorm_0"]["bias"])
        sd[f"{key}.bn.running_mean"] = t(stats["BatchNorm_0"]["mean"])
        sd[f"{key}.bn.running_var"] = t(stats["BatchNorm_0"]["var"])
    return {k: v.contiguous() for k, v in sd.items()}


def state_dict_to_variables(sd: Dict[str, torch.Tensor],
                            transposed: Optional[Collection[str]] = None) -> Dict[str, Any]:
    """State dict -> JAX variables tree of float32 numpy arrays. ``transposed`` holds the
    paths (``decoder.upcnv7``) of the layers whose conv is transposed; None takes those
    with ``upcnv`` in their name."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    n = lambda v: v.detach().cpu().float().numpy()

    def node(tree, path):
        for name in path:
            tree = tree.setdefault(name, {})
        return tree

    for key, v in sd.items():
        parts = key.split(".")
        if parts[-2] == "conv":
            is_t = ("upcnv" in parts[-3] if transposed is None
                    else ".".join(parts[:-2]) in transposed)
            kind = "TFConvTranspose_0" if is_t else "Conv_0"
            conv = node(params, parts[:-2]).setdefault(kind, {})
            if parts[-1] == "weight":
                conv["kernel"] = n(v).transpose(_TO_JAX)
            else:
                conv["bias"] = n(v)
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


def module_variables(model: torch.nn.Module) -> Dict[str, Any]:
    """``model``'s JAX variables tree, its transposed convs found by their type."""
    transposed = {name.rsplit(".", 1)[0] for name, m in model.named_modules()
                  if isinstance(m, TFConvTranspose)}
    return state_dict_to_variables(model.state_dict(), transposed)


def load_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> None:
    """Load a JAX variables tree into ``model``, each layer without a batch norm mapped as
    ``model``'s keys name it. A tree of other layers or shapes raises ``RuntimeError``
    before anything is loaded."""
    want = model.state_dict()
    sd = variables_to_state_dict(variables, want)
    if sorted(sd) != sorted(want) or any(sd[k].shape != want[k].shape for k in sd):
        raise RuntimeError(f"the tree holds other layers or shapes than "
                           f"{type(model).__name__}")
    model.load_state_dict(sd, strict=True)


def dispnet_variant(variables: Dict[str, Any]) -> DispNetVariant:
    """The ``DispNetVariant`` of a DispNet tree: depth10_flow where it has a
    ``flow_decoder``, sfm where its heads have 3 channels, depth4_nobn where ``cnv1`` has
    no batch norm, else depth4."""
    params = variables["params"]
    if "flow_decoder" in params:
        return DispNetVariant.depth10_flow()
    if np.shape(params["decoder"]["disp1"]["Conv_0"]["kernel"])[3] == 3:
        return DispNetVariant.sfm()
    if "BatchNorm_0" not in params["encoder"]["cnv1"]:
        return DispNetVariant.depth4_nobn()
    return DispNetVariant.depth4()


def dispnet_from_variables(variables: Dict[str, Any], *, device="cuda") -> DispNet:
    """An eval-mode float32 ``DispNet`` on ``device`` holding ``variables`` (strict
    load), of the tree's variant (``dispnet_variant``); the input channels are those of
    ``cnv1``'s kernel."""
    params = variables["params"]
    model = DispNet(dispnet_variant(variables),
                    in_channels=np.shape(params["encoder"]["cnv1"]["Conv_0"]["kernel"])[2])
    load_variables(model, variables)
    return model.eval().to(device)


def _kernel_shape(params: Dict[str, Any], layer: str) -> tuple:
    return np.shape(params[layer]["Conv_0"]["kernel"])


def depth_pose_from_variables(variables: Dict[str, Any], *, device="cuda") -> DepthPoseNet:
    """An eval-mode float32 ``DepthPoseNet`` on ``device`` holding ``variables`` (strict
    load): full resolution where the tree has ``disp1``, as many sources as ``pose_pred``
    has outputs / 6, and the input channels of ``cnv1``'s kernel (11 for the
    flow-augmented net)."""
    params = variables["params"]
    model = DepthPoseNet(full_resolution="disp1" in params,
                         num_source=_kernel_shape(params, "pose_pred")[3] // 6,
                         in_channels=_kernel_shape(params, "cnv1")[2])
    load_variables(model, variables)
    return model.eval().to(device)


def pose_exp_from_variables(variables: Dict[str, Any], *, device="cuda") -> PoseExpNet:
    """An eval-mode float32 ``PoseExpNet`` on ``device`` holding ``variables`` (strict
    load): as many sources as ``pose_pred`` has outputs / 6, the explainability decoder
    where the tree has ``mask1``, and the input channels of ``cnv1``'s kernel."""
    params = variables["params"]
    model = PoseExpNet(num_source=_kernel_shape(params, "pose_pred")[3] // 6,
                       do_exp="mask1" in params, in_channels=_kernel_shape(params, "cnv1")[2])
    load_variables(model, variables)
    return model.eval().to(device)


def upconv_from_variables(variables: Dict[str, Any], *, device="cuda") -> UpconvNet:
    """An eval-mode float32 ``UpconvNet`` on ``device`` holding ``variables`` (strict
    load), r0's channels those of ``upcnv5``'s kernel."""
    model = UpconvNet(in_channels=_kernel_shape(variables["params"], "upcnv5")[2])
    load_variables(model, variables)
    return model.eval().to(device)


def lrnet_from_variables(variables: Dict[str, Any], *, device="cuda") -> LRNet:
    """An eval-mode float32 ``LRNet`` on ``device`` holding ``variables`` (strict load):
    with the single-view net where the tree has ``single``; the same path mapping as
    ``dispnet_from_variables`` and ``depth_pose_from_variables`` under each submodule."""
    model = LRNet(with_single="single" in variables["params"])
    load_variables(model, variables)
    return model.eval().to(device)


def turbo_from_variables(variables: Dict[str, Any], variant: TurboVariant, *,
                         device="cuda") -> TurboDepthNet:
    """An eval-mode float32 ``TurboDepthNet(variant)`` on ``device`` holding ``variables``
    (strict load: a tree of another variant raises ``RuntimeError``)."""
    model = TurboDepthNet(variant)
    load_variables(model, variables)
    return model.eval().to(device)
