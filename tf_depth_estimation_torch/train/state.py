"""Train state: the model (parameters and batch-norm running statistics), Adam and the
step counter.

The port of ``tf_depth_estimation_tpu/train/state.py``. JAX keeps the state as an
immutable pytree and returns a new one per step; here the model and the optimizer are
updated in place. ``torch.optim.Adam(betas=(beta1, 0.999), eps=1e-8)`` computes optax's
``adam`` update, ``lr * m_hat / (sqrt(v_hat) + eps)`` with ``m_hat = m / (1 - b1^t)`` and
``v_hat = v / (1 - b2^t)`` (torch divides ``sqrt(v)`` by ``sqrt(1 - b2^t)`` and ``lr`` by
``1 - b1^t``, the same quantity; ``tests/test_torch_train.py`` checks it against optax).
A state with an ``lr_schedule`` sets Adam's learning rate to ``lr_schedule(step)`` before
each update, as optax evaluates a schedule at the count of updates made so far.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from tf_depth_estimation_torch.weights import load_variables, module_variables


def adam(params, learning_rate: float, beta1: float = 0.9) -> torch.optim.Adam:
    """TF1 ``AdamOptimizer`` / optax ``adam`` parity: beta2 0.999, epsilon 1e-8."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(beta1, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_schedule: Optional[Callable[[int], float]] = None

    def set_learning_rate(self) -> None:
        """Adam's learning rate for the update at ``step``, from ``lr_schedule``."""
        if self.lr_schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.step)

    def variables(self) -> Dict[str, Any]:
        """The JAX variables tree ``{"params", "batch_stats"}`` as float32 numpy."""
        return module_variables(self.model)

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Load a JAX variables tree (e.g. a JAX ``create_train_state`` init)."""
        load_variables(self.model, variables)


def create_train_state(model: nn.Module, learning_rate: float = 2e-4, beta1: float = 0.9,
                       lr_schedule: Optional[Callable[[int], float]] = None) -> TrainState:
    """Adam over ``model``'s parameters, step 0; ``model`` is used as given (its init and
    device). With ``lr_schedule`` (step -> learning rate) the constant is not used."""
    return TrainState(model, adam(model.parameters(), learning_rate, beta1),
                      lr_schedule=lr_schedule)
