"""Training loop: step timing, metric logging and checkpointing.

The port of ``tf_depth_estimation_tpu/train/loop.py`` without its TensorBoard mirror,
image summaries and profiler hooks. Throughput counters (steps/s, frames/s) are read on
the host clock at each summary, after the metrics' read has synchronised the device.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterator, Optional

from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.state import TrainState


class MetricLogger:
    """``<directory>/metrics.jsonl`` (one JSON object per record) and stdout."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, scope: str, values: dict):
        rec = {"step": int(step), "scope": scope}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        flat = " ".join(f"{k}={v:.5g}" for k, v in rec.items() if k not in ("step", "scope"))
        print(f"[{scope}] step {step}: {flat}")

    def close(self):
        self._f.close()


def run_training(*, state: TrainState, train_step: Callable, batches: Iterator[dict],
                 max_steps: int, logger: MetricLogger,
                 checkpoint: Optional[CheckpointManager] = None,
                 save_latest_freq: int = 1000, summary_freq: int = 100,
                 validation_check: int = 0, val_fn: Optional[Callable] = None):
    """Drive ``train_step`` over ``batches`` from ``state.step`` to ``max_steps`` (or the
    end of the batches). Every ``validation_check`` steps ``val_fn(state)`` gives a dict
    of metrics, logged as a ``"val"`` record, or None, logged as nothing. Saves every
    ``save_latest_freq`` steps and at the end; returns ``(state, last logged metrics)``."""
    start = state.step
    t0 = time.time()
    frames = 0
    last_metrics = None
    for step in range(start, max_steps):
        try:
            batch = next(batches)
        except StopIteration:
            break
        state, metrics = train_step(state, batch)
        frames += next(iter(batch.values())).shape[0]
        if summary_freq and (step + 1) % summary_freq == 0:
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs the device
            dt = time.time() - t0
            metrics["steps_per_sec"] = (step + 1 - start) / dt
            metrics["frames_per_sec"] = frames / dt
            logger.log(step + 1, "train", metrics)
            last_metrics = metrics
        if validation_check and val_fn and (step + 1) % validation_check == 0:
            val = val_fn(state)
            if val is not None:
                logger.log(step + 1, "val", val)
        if checkpoint is not None and (step + 1) % save_latest_freq == 0:
            checkpoint.save(step + 1, state)
    if checkpoint is not None and checkpoint.latest_step() != state.step:
        checkpoint.save(state.step, state)
    return state, last_metrics
