"""Eval forward of ``TurboDepthNet`` with batch norm folded: the serving graph.

``fast_turbo_forward`` is the port of ``tf_depth_estimation_tpu/infer/fast_turbo.py``: each
BN scale folded into its conv kernel's output channels, the shift left as the conv bias,
and the disparity head's conv and bias as they are (``infer/fast.py:fold_layers``). It
returns the full-resolution disparity [B, H, W, 1] in float32, what ``TurboDepthNet`` in
eval mode returns with ``full_only=True``. JAX's ``fold="base"|"all"`` move the shift into
the contraction through an appended ones channel, so that the TPU's conv has no epilogue
add; they compute the same outputs as ``fold="none"``. cuDNN adds a bias in its epilogue,
so that rewrite has no counterpart here and the port's forward is ``fold="none"``.

Inside, tensors are NCHW in the channels-last memory format. cuDNN runs float32 convs in
TF32 unless ``torch.backends.cudnn.allow_tf32`` is False; parity checks in float32 turn it
off.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch
from torch import nn

from tf_depth_estimation_torch.infer.fast import float_state, fold_layers
from tf_depth_estimation_torch.models.layers import conv2d_same
from tf_depth_estimation_torch.models.turbo import (
    TurboVariant,
    decoder_levels,
    stem_input,
    to_disp,
)
from tf_depth_estimation_torch.ops.phase import depth_to_space_n


def fold_turbo(variables_or_module: Union[Dict[str, Any], nn.Module], *,
               dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """``{layer: (weight, bias)}`` in ``dtype`` on ``device`` (weights channels-last) from
    a JAX turbo variables tree or a ``TurboDepthNet``, plus ``"dtype"``."""
    folded = fold_layers(float_state(variables_or_module, device), dtype)
    folded["dtype"] = dtype
    return folded


def folded_turbo_forward(folded: Dict[str, Any], image: torch.Tensor,
                         variant: TurboVariant) -> torch.Tensor:
    """Forward from ``fold_turbo``'s output. image: [B, H, W, 3] (uint8 or float) on the
    weights' device; returns the full-resolution disparity [B, H, W, 1] float32."""
    def conv(x, name, stride, relu):
        w, b = folded[name]
        y = conv2d_same(x, w, b, stride)
        return torch.relu(y) if relu else y

    x = stem_input(image, variant, folded["dtype"]).contiguous(
        memory_format=torch.channels_last)
    base = decoder_levels(x, variant, conv)[1]
    logits = conv(base, "disp1", 1, False).permute(0, 2, 3, 1)
    return to_disp(depth_to_space_n(logits, variant.patch), variant)


def fast_turbo_forward(variables_or_module: Union[Dict[str, Any], nn.Module],
                       image: torch.Tensor, variant: TurboVariant, *,
                       dtype: torch.dtype = torch.bfloat16,
                       device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Eval-mode turbo forward with BN folded; returns [B, H, W, 1] float32.

    ``image``: [B, H, W, 3], uint8 or float, NHWC; it is moved to ``device`` and converted
    to ``dtype`` there. Matches ``TurboDepthNet`` in eval mode with ``full_only=True``
    (``tests/test_torch_turbo.py``)."""
    folded = fold_turbo(variables_or_module, dtype=dtype, device=device)
    return folded_turbo_forward(folded, torch.as_tensor(image).to(device), variant)
