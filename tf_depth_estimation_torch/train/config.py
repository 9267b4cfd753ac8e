"""Experiment configurations: the port of ``tf_depth_estimation_tpu/train/config.py``.

Typed equivalents of each reference entry point's ``tf.app.flags`` block and the constants
set after parsing (SURVEY §5), over the port's ``LossWeights`` presets (whose samplers
follow the port's presets, ``losses/config.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from tf_depth_estimation_torch.losses.config import LossWeights


@dataclasses.dataclass
class ExperimentConfig:
    name: str
    weights: LossWeights
    dataset_dir: str = ""
    checkpoint_dir: str = "./checkpoints"
    batch_size: int = 10
    learning_rate: float = 2e-4
    beta1: float = 0.9
    max_steps: int = 20_000
    validation_check: int = 100
    save_latest_freq: int = 1000
    summary_freq: int = 100
    continue_train: bool = False
    seed: int = 0
    compute_dtype: str = "bfloat16"
    # data-parallel replicas (1: one device, the reference's single GPU; None: all)
    num_devices: Optional[int] = None

    @classmethod
    def depth_only(cls, **kw) -> "ExperimentConfig":
        """``train_depth_only.py`` flags (lines 17-40): 240x720 colon pairs, batch 10."""
        return cls(name="depth_only", weights=LossWeights.depth_only(), batch_size=10,
                   max_steps=20_000, **kw)

    @classmethod
    def depth_then_cam(cls, **kw) -> "ExperimentConfig":
        """``train_depth_then_cam.py`` flags: DeMoN 192x256, batch 16."""
        return cls(name="depth_then_cam", weights=LossWeights.depth_then_cam(),
                   batch_size=16, max_steps=200_000, save_latest_freq=1000,
                   summary_freq=1000, **kw)

    @classmethod
    def optflow_combine(cls, **kw) -> "ExperimentConfig":
        """``train_optflow_combine.py`` flags: 224x480, batch 10."""
        return cls(name="optflow_combine", weights=LossWeights.optflow_combine(),
                   batch_size=10, max_steps=20_000, **kw)

    @classmethod
    def on_demon(cls, **kw) -> "ExperimentConfig":
        """``train_depth_only_onDemon.py`` flags: DeMoN, batch 16, a save every 100."""
        return cls(name="on_demon", weights=LossWeights.on_demon(), batch_size=16,
                   max_steps=200_000, save_latest_freq=100, **kw)

    @classmethod
    def split_training(cls, **kw) -> "ExperimentConfig":
        """``split_training.py`` flags: the pairwise curriculum, batch 1 (the reference's
        default), 600k + 150k steps, exponentially decayed learning rate."""
        return cls(name="split_training", weights=LossWeights.split_training(),
                   batch_size=1, max_steps=600_001, save_latest_freq=5000, **kw)
