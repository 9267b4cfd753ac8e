"""Training-time schedules (port of ``tf_depth_estimation_tpu/ops/schedules.py``).

Both return a Python float of a float32 value, computed in float32 as the JAX functions
compute it, for a step that is a Python int (the port keeps the step on the host).
"""
from __future__ import annotations

import numpy as np


def ease_out_quad(t, b: float, c: float, d: float) -> float:
    """``b + c * (1 - (1 - t/d)^2)`` for t < d, ``b + c`` afterwards (tfutils' easing,
    which ramps the sig-loss weight at ``my_losses.py:57,139``)."""
    f = np.float32
    tt = np.clip(f(t) / f(d), f(0.0), f(1.0))
    return float(f(b) + f(c) * (f(1.0) - (f(1.0) - tt) ** 2))


def exponential_decay(lr: float, decay_steps: int, decay_rate: float,
                      staircase: bool = True):
    """TF1 ``tf.train.exponential_decay`` (``split_training.py:330-334``): step ->
    ``lr * decay_rate ** p`` with ``p = step / decay_steps``, floored under
    ``staircase``."""
    f = np.float32

    def schedule(step: int) -> float:
        p = f(step) / f(decay_steps)
        if staircase:
            p = np.floor(p)
        return float(f(lr) * f(decay_rate) ** p)

    return schedule
