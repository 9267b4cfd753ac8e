"""Teacher -> student distillation: the port of ``tf_depth_estimation_tpu/train/distill.py``.

A trained depth4 DispNet supervises a ``TurboDepthNet`` student that learns its whole
4-scale sigmoid*4 disparity pyramid, so the student drops into every depth4 serving
surface. The loss is a per-scale mean L1 between the two pyramids, weighted ``w/2**s``
like the reference's multi-scale depth losses (``my_losses.py:65-96``).

The teacher is a callable from [B, H, W, 3] images to its pyramid, run frozen under
``torch.no_grad()`` (not ``inference_mode``: its tensors enter the student's loss). JAX
applies the teacher module in eval mode; ``folded_teacher`` computes the same function
through the serving forward, BN folded, with the decoder tail on the fused kernel
(``ops/fused_tail.py``) on the card and its plain version on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Union

import torch

from tf_depth_estimation_torch.infer.fast import fold_weights, folded_forward
from tf_depth_estimation_torch.train.state import TrainState
from tf_depth_estimation_torch.train.steps import _apply

Teacher = Callable[[torch.Tensor], List[torch.Tensor]]
SCALE_WEIGHTS = (1.0, 0.5, 0.25, 0.125)


def folded_teacher(variables: Dict[str, Any], *, dtype: torch.dtype = torch.bfloat16,
                   tail: str = "fused", device: Union[str, torch.device] = "cuda") -> Teacher:
    """The eval forward of a depth4 DispNet variables tree (with batch statistics), BN
    folded once here; images -> [d1, d2, d3, d4] float32 NHWC."""
    folded = fold_weights(variables, dtype=dtype, device=device)
    return lambda images: folded_forward(folded, images, tail=tail)


def distill_loss(student_preds, teacher_preds, scale_weights: Sequence[float]):
    """Weighted per-scale mean L1 between two disparity pyramids of equal shapes; the
    teacher's side carries no gradient."""
    if len(student_preds) != len(teacher_preds):
        raise ValueError(f"{len(student_preds)} student scales, {len(teacher_preds)} "
                         f"teacher scales")
    comps = {}
    total = 0.0
    for s, (sp, tp, w) in enumerate(zip(student_preds, teacher_preds, scale_weights)):
        if sp.shape != tp.shape:
            raise ValueError(f"scale {s}: student {tuple(sp.shape)}, teacher "
                             f"{tuple(tp.shape)}")
        li = (sp - tp.detach()).abs().mean()
        comps[f"distill_l1_s{s}"] = li
        total = total + w * li
    comps["total_loss"] = total
    return total, comps


def _teacher_pyramid(teacher: Teacher, images: torch.Tensor, n: int) -> List[torch.Tensor]:
    with torch.no_grad():
        return [p.float() for p in teacher(images)[:n]]


def make_distill_step(teacher: Teacher, scale_weights: Sequence[float] = SCALE_WEIGHTS):
    """Returns ``step(state, images) -> (state, metrics)``: the teacher's frozen pyramid,
    the student's train-mode forward (which moves its BN statistics), ``distill_loss``, the
    backward and the Adam update."""

    def step(state: TrainState, images: torch.Tensor):
        t_preds = _teacher_pyramid(teacher, images, len(scale_weights))
        state.model.train()
        s_preds = state.model.forward_nhwc(images)
        return _apply(state, *distill_loss(s_preds[:len(t_preds)], t_preds,
                                           scale_weights[:len(t_preds)]))

    return step


def make_distill_eval(teacher: Teacher):
    """Returns ``eval(state, images) -> metrics``, no update: the full-resolution mean
    absolute error and abs-rel of the student's eval forward against the teacher's."""

    def eval_step(state: TrainState, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        (t_full,) = _teacher_pyramid(teacher, images, 1)
        state.model.eval()
        with torch.no_grad():
            s_full = state.model.forward_nhwc(images)[0]
            err = (s_full - t_full).abs()
            return {"mae_vs_teacher": err.mean(),
                    "absrel_vs_teacher": (err / t_full.clamp_min(1e-3)).mean()}

    return eval_step
