"""Bilinear sampling at per-pixel coordinates, routed between the kernel and the plain
version.

The port of ``tf_depth_estimation_tpu/geometry/sampling.py`` (ref ``utils_lr.py:276-366``):
taps at floor and floor + 1 clamped to the image, a tap whose unclamped index is outside
gets weight 0, and ``wmask`` is the sum of the four weights.

``sampler`` keeps the JAX package's three entry points (``tf_depth_estimation_tpu/ops/
__init__.py:14`` exports the third):

* ``"pallas"``: the port's hand-written sampler (``ops/bilinear_sample.py``, CUDA source
  ``csrc/bilinear_sample.cu``). On a CUDA tensor every call launches it, at every size
  (the JAX package's TPU shape gate does not apply); on a CPU tensor the call runs the
  plain version.
* ``"fused"``: the port of the fused warp (``ops/bilinear_sample_fused.py``): the same
  kernels under JAX's eligibility rule and counts of their own. Same-size warps with
  B % 8 == 0 launch them on this route, other calls on the ``"pallas"`` route; on a CPU
  tensor the plain version. JAX's geometry reaches it only through
  ``ops.bilinear_sample_fused``; the port's ``LossWeights.depth_then_cam()`` selects it.
* ``"xla"``: the plain PyTorch version, differentiated by autograd.

``bilinear_sample_group`` takes a step's warps as two lists, in one launch each way a
route on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from tf_depth_estimation_torch.ops.bilinear_sample import (
    bilinear_sample as _kernel_sample,
    bilinear_sample_group as _kernel_group,
    bilinear_sample_reference,
    plain_group,
)
from tf_depth_estimation_torch.ops.bilinear_sample_fused import (
    bilinear_sample_fused,
    bilinear_sample_fused_group,
)

SAMPLERS = ("xla", "pallas", "fused")


def bilinear_sample(imgs: torch.Tensor, coords: torch.Tensor, sampler: str = "xla"):
    """Sample ``imgs`` [B, Hs, Ws, C] at ``coords`` [B, Ht, Wt, 2] (x, y).

    Returns (output ``[B, Ht, Wt, C]``, wmask ``[B, Ht, Wt, 1]``)."""
    if sampler == "pallas":
        return _kernel_sample(imgs, coords)
    if sampler == "fused":
        return bilinear_sample_fused(imgs, coords)
    if sampler == "xla":
        return bilinear_sample_reference(imgs, coords)
    raise ValueError(f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")


def bilinear_sample_group(imgs: Sequence[torch.Tensor], coords: Sequence[torch.Tensor],
                          sampler: str = "xla"):
    """``bilinear_sample(imgs[k], coords[k], sampler)`` for every k, as two lists (outputs,
    wmasks): one call of the sampler's group wrapper."""
    if sampler == "pallas":
        return _kernel_group(imgs, coords)
    if sampler == "fused":
        return bilinear_sample_fused_group(imgs, coords)
    if sampler == "xla":
        return plain_group(imgs, coords)
    raise ValueError(f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
