"""Depth visualisation helpers (ref ``utils_lr.py:6-24``): the port of
``tf_depth_estimation_tpu/utils/viz.py``. matplotlib is imported only where a colour map
is applied."""
from __future__ import annotations

import numpy as np


def gray2rgb(im: np.ndarray, cmap: str = "gray") -> np.ndarray:
    """[..] values in [0, 1] -> [.., 3] RGB through a matplotlib colour map."""
    import matplotlib.pyplot as plt

    rgba = plt.get_cmap(cmap)(im.astype(np.float32))
    return rgba[..., :3]


def normalize_depth_for_display(depth: np.ndarray, pc: int = 95, crop_percent: float = 0.0,
                                normalizer=None, cmap: str = "gray") -> np.ndarray:
    """Percentile-normalised disparity as an RGB image (ref ``utils_lr.py:12-24``): 1 / depth
    over its ``pc``-th percentile (or ``normalizer``), clipped to [0, 1], coloured, and the
    bottom ``crop_percent`` of the rows cut."""
    disp = 1.0 / (depth + 1e-6)
    if normalizer is not None:
        disp = disp / normalizer
    else:
        disp = disp / (np.percentile(disp, pc) + 1e-6)
    disp = np.clip(disp, 0, 1)
    disp = gray2rgb(disp, cmap=cmap)
    keep_h = int(disp.shape[0] * (1 - crop_percent))
    return disp[:keep_h]
