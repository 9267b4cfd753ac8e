"""The fused bilinear warp sampler: the grouped CUDA sampler under JAX's eligibility rule, and
the plain version.

``bilinear_sample_fused(imgs, coords)`` takes ``imgs`` [B, Hs, Ws, C] and ``coords``
[B, Ht, Wt, 2] (x, y), float32, and returns ``(out [B, Ht, Wt, C], wmask [B, Ht, Wt, 1])``,
the function of ``ops/bilinear_sample.py`` (the reference border rule);
``bilinear_sample_fused_group(imgs, coords)`` does so for two lists, a training step's
warps in one call, and ``bilinear_sample_fused`` is a group of one. They replace
``tf_depth_estimation_tpu/ops/pallas_warp.py:144 bilinear_sample_fused`` (kernel
``_warp_kernel`` at ``:51``) and keep its eligibility rule word for word (``_supported``,
``pallas_warp.py:93-96``): ``Ht * Wt == Hs * Ws``, ``B % 8 == 0`` and ``Hs * Ws <= 131072``.
The rule compares products, not shapes, so a 16x24 image sampled at 24x16 coords is
eligible.

* On CUDA tensors the eligible members of a group launch the grouped sampler kernels of
  ``csrc/bilinear_sample.cu`` once each way, counted in ``bilinear_sample_fused.launches``
  and ``.backward_launches``: the forward writes ``out`` and ``wmask`` and nothing else,
  the backward recomputes the four taps and writes ``dcoords`` (and ``dimgs``, scattered
  with atomics, when the image needs a gradient). The members outside the rule, where JAX
  falls back to its plain sampler, take the same kernels as ``ops/bilinear_sample.py``'s
  route and its counts (``bilinear_sample.launches``): the kernels compute the plain
  sampler bit for bit. So a mixed group makes at most one launch a route each way. Either
  launches or raises.
* On CPU tensors every member is ``bilinear_sample_reference``, the plain version, under
  autograd, as JAX's backward is autodiff of its plain sampler (``pallas_warp.py:153-156``).

The wrapper makes ``imgs`` and ``coords`` contiguous (the warps' coordinates may arrive as
views) and takes float32 only. A gradient of ``wmask`` may be absent: config 3 never reads
the mask, and an absent gradient is read as zeros without being made.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tf_depth_estimation_torch.ops.bilinear_sample import (
    bilinear_sample,
    check_group,
    launch_group,
    plain_group,
)

_S = 8               # batch multiple of the JAX kernel's blocks (pallas_warp.py:45)
_MAX_HW = 131072     # its flat-image limit (pallas_warp.py:46)


def _supported(imgs: torch.Tensor, coords: torch.Tensor) -> bool:
    """JAX's rule (``pallas_warp.py:93-96``): a same-size warp, B % 8 == 0 and a flat
    image of at most 131,072 pixels."""
    B, Hs, Ws, C = imgs.shape
    _, Ht, Wt, _ = coords.shape
    return (Ht * Wt == Hs * Ws) and (B % _S == 0) and (Hs * Ws <= _MAX_HW)


def bilinear_sample_fused_group(imgs: Sequence[torch.Tensor],
                                coords: Sequence[torch.Tensor]) -> Tuple[list, list]:
    """(outs, wmasks) of float32 ``imgs[k]`` [B,Hs,Ws,C] sampled at ``coords[k]``
    [B,Ht,Wt,2]. On CUDA tensors the members inside JAX's rule make one launch each way,
    and those outside it one on the sampler's route (or the call raises); on CPU tensors
    the plain version member by member."""
    imgs, coords = [i.contiguous() for i in imgs], [c.contiguous() for c in coords]
    check_group(imgs, coords)
    if not imgs[0].is_cuda:
        return plain_group(imgs, coords)
    eligible = [_supported(i, c) for i, c in zip(imgs, coords)]
    outs, wmasks = [None] * len(imgs), [None] * len(imgs)
    for counter, inside in ((bilinear_sample_fused, True), (bilinear_sample, False)):
        ks = [k for k, e in enumerate(eligible) if e == inside]
        if ks:
            o, w = launch_group(counter, [imgs[k] for k in ks], [coords[k] for k in ks])
            for k, ok, wk in zip(ks, o, w):
                outs[k], wmasks[k] = ok, wk
    return outs, wmasks


def bilinear_sample_fused(imgs: torch.Tensor, coords: torch.Tensor):
    """(out [B,Ht,Wt,C], wmask [B,Ht,Wt,1]) from float32 ``imgs`` [B,Hs,Ws,C] and
    ``coords`` [B,Ht,Wt,2]: a group of one. On a CUDA tensor this launches the kernels on
    this route, or on the sampler's route for a call outside JAX's rule, or raises; on a
    CPU tensor it is the plain version."""
    outs, wmasks = bilinear_sample_fused_group([imgs], [coords])
    return outs[0], wmasks[0]


bilinear_sample_fused.launches = 0
bilinear_sample_fused.backward_launches = 0
