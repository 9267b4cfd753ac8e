"""Training loop: step timing, metric logging, image summaries, the profiler hook and
checkpointing; the port of ``tf_depth_estimation_tpu/train/loop.py``.

Throughput counters (steps/s, frames/s) are read on the host clock at each summary, after
the metrics' read has synchronised the device. ``MetricLogger`` mirrors its records to
TensorBoard event files under ``<directory>/sum`` through
``torch.utils.tensorboard.SummaryWriter`` (the ``tensorboard`` package, imported only on
request) with the JAX package's tags, ``<scope>/<metric>`` for scalars and the summary
names for images and histograms. ``run_training(profile_dir=...)`` records a
``torch.profiler`` trace (host and, on the card, device activity) of the steps
``[profile_steps[0], profile_steps[1])``, as JAX's loop records a ``jax.profiler`` trace.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.state import TrainState


class MetricLogger:
    """``<directory>/metrics.jsonl`` (one JSON object per record) and stdout (unless
    ``quiet``), and with ``tensorboard=True`` TensorBoard event files under
    ``<directory>/sum`` (the reference's writer path, ``train_depth_then_cam.py:319``).
    Where the ``tensorboard`` package is missing it says "tensorboard writer unavailable"
    and logs on without the mirror, as the JAX package does."""

    def __init__(self, directory: str, quiet: bool = False, tensorboard: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.quiet = quiet
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(directory, "sum"))
            except Exception as e:
                print(f"tensorboard writer unavailable: {e}")

    def log(self, step: int, scope: str, values: dict):
        rec = {"step": int(step), "scope": scope}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "scope"):
                    self._tb.add_scalar(f"{scope}/{k}", v, global_step=int(step))
            self._tb.flush()
        if not self.quiet:
            flat = " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                            if k not in ("step", "scope"))
            print(f"[{scope}] step {step}: {flat}")

    def log_images(self, step: int, images: dict):
        """Image summaries of uint8 [N, H, W, C] arrays, one tag each (the reference's
        per-scale ``tf.summary.image`` set, ``split_training.py:290-325``); nothing
        without the TensorBoard writer (the JSONL file carries no images)."""
        if self._tb is None:
            return
        for name, img in images.items():
            self._tb.add_images(name, np.asarray(img), global_step=int(step),
                                dataformats="NHWC")
        self._tb.flush()

    def log_histograms(self, step: int, hists: dict):
        """Histogram summaries (``split_training.py:283-303``); nothing without the
        writer."""
        if self._tb is None:
            return
        for name, v in hists.items():
            self._tb.add_histogram(name, np.asarray(v), global_step=int(step))
        self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class _StepProfiler:
    """A ``torch.profiler`` session over a range of steps, written as one Chrome trace
    ``<directory>/steps_<a>-<b>.pt.trace.json``."""

    def __init__(self, directory: str, steps: tuple):
        self.directory, self.steps = directory, steps
        self._prof = None
        self.path = None

    def before(self, step: int) -> None:
        if step == self.steps[0] and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def after(self, step: int, last: bool = False) -> None:
        if self._prof is None or not (step + 1 == self.steps[1] or last):
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory,
                                 f"steps_{self.steps[0]}-{step + 1}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None


def run_training(*, state: TrainState, train_step: Callable, batches: Iterator[dict],
                 max_steps: int, logger: MetricLogger,
                 checkpoint: Optional[CheckpointManager] = None,
                 save_latest_freq: int = 1000, summary_freq: int = 100,
                 validation_check: int = 0, val_fn: Optional[Callable] = None,
                 image_summary_fn: Optional[Callable] = None, image_summary_freq: int = 0,
                 profile_dir: Optional[str] = None, profile_steps: tuple = (10, 15)):
    """Drive ``train_step`` over ``batches`` from ``state.step`` to ``max_steps`` (or the
    end of the batches). Every ``validation_check`` steps ``val_fn(state)`` gives a dict
    of metrics, logged as a ``"val"`` record, or None, logged as nothing. Every
    ``image_summary_freq`` steps ``image_summary_fn(state, batch)`` gives (images,
    histograms) for the logger (``train/summaries.py``). ``profile_dir`` records a
    profiler trace of steps ``[profile_steps)`` there (cut at the last step if the run
    ends inside the range). Saves every ``save_latest_freq`` steps and at the end;
    returns ``(state, last logged metrics)``."""
    start = state.step
    t0 = time.time()
    frames = 0
    last_metrics = None
    profiler = _StepProfiler(profile_dir, profile_steps) if profile_dir else None
    for step in range(start, max_steps):
        if profiler:
            profiler.before(step)
        try:
            batch = next(batches)
        except StopIteration:
            break
        state, metrics = train_step(state, batch)
        frames += next(iter(batch.values())).shape[0]
        if profiler:
            profiler.after(step)
        if summary_freq and (step + 1) % summary_freq == 0:
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs the device
            dt = time.time() - t0
            metrics["steps_per_sec"] = (step + 1 - start) / dt
            metrics["frames_per_sec"] = frames / dt
            logger.log(step + 1, "train", metrics)
            last_metrics = metrics
        if image_summary_fn and image_summary_freq and (step + 1) % image_summary_freq == 0:
            images, hists = image_summary_fn(state, batch)
            logger.log_images(step + 1, images)
            logger.log_histograms(step + 1, hists)
        if validation_check and val_fn and (step + 1) % validation_check == 0:
            val = val_fn(state)
            if val is not None:
                logger.log(step + 1, "val", val)
        if checkpoint is not None and (step + 1) % save_latest_freq == 0:
            checkpoint.save(step + 1, state)
    if profiler:
        profiler.after(state.step - 1, last=True)
    if checkpoint is not None and checkpoint.latest_step() != state.step:
        checkpoint.save(state.step, state)
    return state, last_metrics
