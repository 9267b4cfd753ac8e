"""The weight bridge: JAX variables tree <-> the port's ``DispNet`` state dict.

The JAX tree (numpy arrays from a ``.npz`` or from ``DispNet.init``) holds
``params/<part>/<layer>/{Conv_0,TFConvTranspose_0}/kernel``, ``.../BatchNorm_0/bias`` and
``batch_stats/<part>/<layer>/BatchNorm_0/{mean,var}``, with the parts ``encoder``,
``decoder`` and, for depth10_flow, ``flow_decoder`` (layers ``upcnv7_opt`` .. ``disp1_opt``);
the state dict uses the same part and layer names. Conv kernels are HWIO and become
OIHW. TF transposed-conv kernels are ``[kh, kw, out, in]`` and become
``conv_transpose2d``'s ``[in, out, kh, kw]``; both are the same axis permutation, and
neither is flipped (``models/layers.py`` says why).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant

_TO_TORCH = (3, 2, 0, 1)    # HWIO -> OIHW, and [kh, kw, out, in] -> [in, out, kh, kw]
_TO_JAX = (2, 3, 1, 0)


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables tree -> ``DispNet`` state dict (float32 CPU tensors)."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd: Dict[str, torch.Tensor] = {}
    for part, layers in variables["params"].items():
        stats = variables.get("batch_stats", {}).get(part, {})
        for name, layer in layers.items():
            key = f"{part}.{name}"
            if "BatchNorm_0" not in layer:     # a disparity head: conv + bias
                sd[f"{key}.weight"] = t(layer["Conv_0"]["kernel"]).permute(_TO_TORCH)
                sd[f"{key}.bias"] = t(layer["Conv_0"]["bias"])
                continue
            conv = layer.get("Conv_0") or layer["TFConvTranspose_0"]
            sd[f"{key}.conv.weight"] = t(conv["kernel"]).permute(_TO_TORCH)
            sd[f"{key}.bn.bias"] = t(layer["BatchNorm_0"]["bias"])
            sd[f"{key}.bn.running_mean"] = t(stats[name]["BatchNorm_0"]["mean"])
            sd[f"{key}.bn.running_var"] = t(stats[name]["BatchNorm_0"]["var"])
    return {k: v.contiguous() for k, v in sd.items()}


def state_dict_to_variables(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``DispNet`` state dict -> JAX variables tree of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    n = lambda v: v.detach().cpu().float().numpy()
    for key, v in sd.items():
        part, name, *rest = key.split(".")
        p = params.setdefault(part, {}).setdefault(name, {})
        if rest == ["weight"]:
            p.setdefault("Conv_0", {})["kernel"] = n(v).transpose(_TO_JAX)
        elif rest == ["bias"]:
            p.setdefault("Conv_0", {})["bias"] = n(v)
        elif rest == ["conv", "weight"]:
            kind = "TFConvTranspose_0" if name.startswith("upcnv") else "Conv_0"
            p[kind] = {"kernel": n(v).transpose(_TO_JAX)}
        elif rest == ["bn", "bias"]:
            p["BatchNorm_0"] = {"bias": n(v)}
        else:
            field = {"running_mean": "mean", "running_var": "var"}[rest[1]]
            stats.setdefault(part, {}).setdefault(name, {}).setdefault(
                "BatchNorm_0", {})[field] = n(v)
    return {"params": params, "batch_stats": stats}


def dispnet_from_variables(variables: Dict[str, Any], *, device="cuda") -> DispNet:
    """An eval-mode float32 ``DispNet`` on ``device`` holding ``variables`` (strict
    load): depth10_flow where the tree has a ``flow_decoder``, else depth4."""
    flow = "flow_decoder" in variables["params"]
    model = DispNet(DispNetVariant.depth10_flow() if flow else DispNetVariant.depth4())
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model.eval().to(device)
