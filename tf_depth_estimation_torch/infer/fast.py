"""Eval forward of depth4 DispNet with batch norm folded, and the fused decoder tail.

``fast_depth_forward`` is the port of ``tf_depth_estimation_tpu/infer/fast.py``: the eval
forward with each BN scale folded into its conv kernel's output channels and the shift
left as the conv bias, returning ``[d1, d2, d3, d4]`` in float32, NHWC. The JAX module's
stem/mid/deconv rewrite modes re-lay convs out for the TPU's matrix unit and compute the
same outputs as the plain convs, so they have no counterpart here.

``tail="fused"`` (the default) computes upcnv1 -> d2 upsample -> icnv1 -> disp1 in one
kernel (``ops/fused_tail.py``), which applies the upcnv1 and icnv1 BN affines after the
f32 sum instead of folding them. ``tail="native"`` is the plain deconv -> resize -> conv
chain. Inside, tensors are NCHW in the channels-last memory format, so the NHWC view that
the fused tail takes of icnv2's output costs no copy.

cuDNN runs float32 convs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False;
parity checks in float32 turn it off, serving in bf16 does not depend on it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
from torch import nn

from tf_depth_estimation_torch.models.dispnet import ENC, DispNet
from tf_depth_estimation_torch.models.layers import bn_affine, conv2d_same, conv_transpose2d_same
from tf_depth_estimation_torch.ops.fused_tail import fused_tail, prepare_tail_params
from tf_depth_estimation_torch.ops.resize import resize_bilinear, resize_like
from tf_depth_estimation_torch.weights import variables_to_state_dict

TAILS = ("fused", "native")


def _cat(xs: List[torch.Tensor]) -> torch.Tensor:
    """Channel concat into a channels-last tensor (``torch.cat`` falls back to NCHW when
    a 1-channel input's strides leave the format ambiguous)."""
    B, _, H, W = xs[0].shape
    out = torch.empty((B, sum(x.shape[1] for x in xs), H, W), dtype=xs[0].dtype,
                      device=xs[0].device, memory_format=torch.channels_last)
    return torch.cat(xs, 1, out=out)


def float_state(variables_or_module: Union[Dict[str, Any], nn.Module],
                device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """The state dict of a JAX variables tree or of a module, float32 on ``device``."""
    sd = (variables_or_module.state_dict() if isinstance(variables_or_module, nn.Module)
          else variables_to_state_dict(variables_or_module))
    return {k: v.detach().to(device=device, dtype=torch.float32) for k, v in sd.items()}


def _affine(sd: Dict[str, torch.Tensor], name: str):
    return bn_affine(*(sd[f"{name}.bn.{k}"] for k in ("bias", "running_mean",
                                                       "running_var")))


def fold_layers(sd: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, Any]:
    """``{layer: (weight, bias)}`` in ``dtype`` (weights channels-last) from a float32
    state dict: each BN scale folded into its conv kernel's output channels and its shift
    left as the conv bias (for the stem as for every other layer: cuDNN adds a bias in the
    convolution's epilogue), and each linear head's conv and bias as they are. A layer is
    keyed by its own name (``cnv1``, ``upcnv7``, ``exp_upcnv5``, ``disp4``, ``pose_pred``),
    for ``DispNet`` and ``DepthPoseNet`` alike; a transposed conv is one whose name holds
    ``upcnv``."""
    cl = lambda w: w.to(dtype).contiguous(memory_format=torch.channels_last)
    folded: Dict[str, Any] = {}
    for key in sd:
        if not key.endswith(".weight"):
            continue
        name = key[: -len(".weight")]
        if name.endswith(".conv"):
            name = name[: -len(".conv")]
            s, t = _affine(sd, name)
            w = sd[key]
            # output channels: dim 0 of OIHW, dim 1 of the transposed conv's [in, out, k, k]
            w = w * (s[None, :, None, None] if "upcnv" in name else s[:, None, None, None])
            folded[name.split(".")[-1]] = (cl(w), t.to(dtype))
        else:                                   # linear heads: conv + bias, no BN
            folded[name.split(".")[-1]] = (cl(sd[key]), sd[f"{name}.bias"].to(dtype))
    return folded


def fold_weights(variables_or_module: Union[Dict[str, Any], DispNet], *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Fold the BN scales of a JAX variables tree or a ``DispNet`` into its kernels.

    Returns ``{layer: (weight, bias)}`` in ``dtype`` on ``device`` (weights channels-last),
    plus ``"tail"``: the fused tail's parameters, prepared for ``dtype``.
    """
    sd = float_state(variables_or_module, device)
    folded = fold_layers(sd, dtype)
    folded["tail"] = prepare_tail_params(
        sd["decoder.upcnv1.conv.weight"], _affine(sd, "decoder.upcnv1"),
        sd["decoder.icnv1.conv.weight"], _affine(sd, "decoder.icnv1"),
        sd["decoder.disp1.weight"], sd["decoder.disp1.bias"], dtype)
    folded["dtype"] = dtype
    return folded


def folded_forward(folded: Dict[str, Any], image: torch.Tensor, *, tail: str = "fused",
                   disp_scaling: float = 4.0, min_disp: float = 0.0) -> List[torch.Tensor]:
    """Forward from ``fold_weights``' output. image: [B, H, W, 3] (uint8 or float) on the
    weights' device; returns ``[d1, d2, d3, d4]`` float32 NHWC."""
    if tail not in TAILS:
        raise ValueError(f"tail must be one of {TAILS}, got {tail!r}")
    H, W = image.shape[1:3]
    if tail == "fused" and (H % 2 or W % 2):
        raise ValueError(f"tail='fused' needs even H and W, got {H}x{W}")
    dt = folded["dtype"]

    def conv(x, name, stride=1):
        w, b = folded[name]
        return conv2d_same(x, w, b, stride)

    def deconv(x, name):
        w, b = folded[name]
        return torch.relu(conv_transpose2d_same(x, w, b))

    def head(x, name):
        return (disp_scaling * torch.sigmoid(conv(x, name)) + min_disp).float()

    x = image.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=torch.channels_last)
    skips = []
    for i in range(1, len(ENC) + 1):
        x = torch.relu(conv(x, f"cnv{i}", 2))
        x = torch.relu(conv(x, f"cnv{i}b"))
        skips.append(x)

    def up_cat(x, lvl, extra):
        x = deconv(x, f"upcnv{lvl}")
        x = resize_like(x, extra[0])
        return torch.relu(conv(_cat([x, *extra]), f"icnv{lvl}"))

    x = skips[6]
    for lvl in (7, 6, 5, 4):
        x = up_cat(x, lvl, [skips[lvl - 2]])
    d4 = head(x, "disp4")
    x = up_cat(x, 3, [skips[1], resize_bilinear(d4, (H // 4, W // 4)).to(dt)])
    d3 = head(x, "disp3")
    x2 = up_cat(x, 2, [skips[0], resize_bilinear(d3, (H // 2, W // 2)).to(dt)])
    d2 = head(x2, "disp2")
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    if tail == "fused":
        d1 = fused_tail(nhwc(x2).contiguous(), nhwc(d2).contiguous(), folded["tail"],
                        disp_scaling=disp_scaling, min_disp=min_disp)
        return [d1, nhwc(d2), nhwc(d3), nhwc(d4)]
    d2u = resize_bilinear(d2, (H, W))
    x = deconv(x2, "upcnv1")
    x = resize_like(x, d2u)
    x = torch.relu(conv(_cat([x, d2u.to(dt)]), "icnv1"))
    return [nhwc(head(x, "disp1")), nhwc(d2), nhwc(d3), nhwc(d4)]


def fast_depth_forward(variables_or_module: Union[Dict[str, Any], DispNet],
                       image: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16,
                       tail: str = "fused", disp_scaling: float = 4.0,
                       min_disp: float = 0.0,
                       device: Union[str, torch.device] = "cuda") -> List[torch.Tensor]:
    """Eval-mode depth4 DispNet forward with BN folded; returns [d1, d2, d3, d4] float32.

    ``image``: [B, H, W, 3], uint8 or float, NHWC; it is moved to ``device`` and converted
    to ``dtype`` there. Matches ``DispNet`` in eval mode (``tests/test_torch_fast_infer.py``).
    """
    folded = fold_weights(variables_or_module, dtype=dtype, device=device)
    return folded_forward(folded, torch.as_tensor(image).to(device), tail=tail,
                          disp_scaling=disp_scaling, min_disp=min_disp)
