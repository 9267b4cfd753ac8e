"""Shared benchmark constants: the port's copy of ``tf_depth_estimation_tpu/utils/
constants.py``.

The serving target the repository was set (BASELINE.json "north_star": ">=10k depth
frames/sec/chip at 576x384"), one definition for every report that compares against it.
It was set for a TPU v5e chip; a figure of the port is measured on its own card.
"""

NORTH_STAR_FPS = 10000.0
