"""Bilinear sampling at per-pixel coordinates, routed between the kernel and the plain
version.

The port of ``tf_depth_estimation_tpu/geometry/sampling.py`` (ref ``utils_lr.py:276-366``):
taps at floor and floor + 1 clamped to the image, a tap whose unclamped index is outside
gets weight 0, and ``wmask`` is the sum of the four weights.

``sampler`` keeps the JAX package's two values:

* ``"pallas"``: the port's hand-written kernel (``ops/bilinear_sample.py``, CUDA source
  ``csrc/bilinear_sample.cu``). On a CUDA tensor every call launches it, at every size
  (the JAX package's TPU shape gate does not apply); on a CPU tensor the call runs the
  plain forward through the same autograd function.
* ``"xla"``: the plain PyTorch version, differentiated by autograd.
"""
from __future__ import annotations

import torch

from tf_depth_estimation_torch.ops.bilinear_sample import (
    bilinear_sample as _kernel_sample,
    bilinear_sample_reference,
)

SAMPLERS = ("xla", "pallas")


def bilinear_sample(imgs: torch.Tensor, coords: torch.Tensor, sampler: str = "xla"):
    """Sample ``imgs`` [B, Hs, Ws, C] at ``coords`` [B, Ht, Wt, 2] (x, y).

    Returns (output ``[B, Ht, Wt, C]``, wmask ``[B, Ht, Wt, 1]``)."""
    if sampler == "pallas":
        return _kernel_sample(imgs, coords)
    if sampler == "xla":
        return bilinear_sample_reference(imgs, coords)
    raise ValueError(f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
