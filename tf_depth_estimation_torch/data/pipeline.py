"""Threaded host batching and the copy to the device.

``BatchLoader`` is the port of ``tf_depth_estimation_tpu/data/pipeline.py:BatchLoader``
(shuffled epochs, fixed batch size, remainder dropped, worker threads), ``StreamLoader``
that of its ``StreamLoader`` (an endless stream of ``dataset.sample(rng)`` draws, the
DeMoN training input), ``IterBatcher`` that of its ``IterBatcher`` (batches of a
restartable sample stream). ``device_prefetch``
replaces the JAX package's ``jax.device_put`` double buffer: each batch is copied into
pinned host memory and sent with a non-blocking copy on the current stream, ``size``
batches ahead of the consumer, so the next batch's copy overlaps the current step.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class BatchLoader:
    """Shuffled, epoch-repeating batch iterator over an indexable dataset of dicts of
    fixed-shape numpy arrays; with more than one worker the batches' order may vary.

    Under data parallelism host ``host_index`` of ``host_count`` shuffles with
    ``RandomState(seed + host_index)`` and reads the slice ``idx[host_index::host_count]``
    of each epoch's order, as the JAX package's hosts do
    (``data/pipeline.py:49-64`` there)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_epochs: Optional[int] = None, num_workers: int = 2,
                 queue_depth: int = 4, host_index: int = 0, host_count: int = 1):
        if len(dataset) == 0:
            raise ValueError("empty dataset")
        if not 0 <= host_index < host_count:
            raise ValueError(f"host_index {host_index} is not in [0, {host_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_epochs = num_epochs
        self.rng = np.random.RandomState(seed + host_index)
        self.host_index = host_index
        self.host_count = host_count
        self.num_workers = num_workers
        self.queue_depth = queue_depth

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        n = len(self.dataset)
        while self.num_epochs is None or epoch < self.num_epochs:
            idx = np.arange(n)
            if self.shuffle:
                self.rng.shuffle(idx)
            yield from idx[self.host_index::self.host_count]
            epoch += 1

    @staticmethod
    def _collate(samples: Sequence[dict]) -> dict:
        return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        idx_stream = self._index_stream()
        idx_lock = threading.Lock()
        out_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()

        def producer():
            try:
                while not stop.is_set():
                    batch_idx = []
                    with idx_lock:
                        for _ in range(self.batch_size):
                            i = next(idx_stream, None)
                            if i is None:
                                return
                            batch_idx.append(i)
                    out_q.put(self._collate([self.dataset[i] for i in batch_idx]))
            except BaseException as e:  # hand it to the consumer instead of hanging it
                out_q.put(e)
            finally:
                out_q.put(None)

        workers = [threading.Thread(target=producer, daemon=True)
                   for _ in range(self.num_workers)]
        for t in workers:
            t.start()
        finished = 0
        try:
            while finished < self.num_workers:
                item = out_q.get()
                if item is None:
                    finished += 1
                elif isinstance(item, BaseException):
                    raise RuntimeError("BatchLoader worker failed") from item
                else:
                    yield item
        finally:
            stop.set()
            while any(t.is_alive() for t in workers):  # unblock producers stuck on put()
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                for t in workers:
                    t.join(timeout=0.01)


class StreamLoader:
    """Endless batches of ``dataset.sample(rng)`` draws by ``num_workers`` threads, each
    with its own ``RandomState`` seeded from (seed, host, worker) as in the JAX package,
    ``(seed * 1000003 + host_index * 9973 + worker_id) & 0x7FFFFFFF``
    (``data/pipeline.py:205`` there), so a run with one worker is deterministic and hosts
    draw decorrelated streams. A worker's failure is raised to the consumer."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 2,
                 queue_depth: int = 4, host_index: int = 0):
        if not hasattr(dataset, "sample"):
            raise TypeError("StreamLoader needs a dataset with .sample(rng)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self.host_index = host_index

    def __iter__(self) -> Iterator[dict]:
        out_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()

        def producer(worker_id: int):
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.host_index * 9973 + worker_id) & 0x7FFFFFFF)
            try:
                while not stop.is_set():
                    samples = []
                    for _ in range(self.batch_size):
                        if stop.is_set():
                            return
                        samples.append(self.dataset.sample(rng))
                    out_q.put(BatchLoader._collate(samples))
            except BaseException as e:  # hand it to the consumer instead of hanging it
                out_q.put(e)

        workers = [threading.Thread(target=producer, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in workers:
            t.start()
        try:
            while True:
                item = out_q.get()
                if isinstance(item, BaseException):
                    raise RuntimeError("StreamLoader worker failed") from item
                yield item
        finally:
            stop.set()
            while any(t.is_alive() for t in workers):  # unblock producers stuck on put()
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                for t in workers:
                    t.join(timeout=0.01)


class IterBatcher:
    """Batches of a restartable stream of sample dicts: ``factory()`` returns a fresh
    sample iterator, and each run of it to its end is one epoch. A partial batch carries
    across an epoch's end (``tf.train.batch`` batches a continuous queue), so only the
    last one, after the last epoch, is dropped. A source that yields no sample raises
    ``ValueError`` rather than yield nothing (or loop forever with ``num_epochs=None``)."""

    def __init__(self, factory: Callable[[], Iterator[dict]], batch_size: int,
                 num_epochs: Optional[int] = None):
        self.factory = factory
        self.batch_size = batch_size
        self.num_epochs = num_epochs

    def __iter__(self) -> Iterator[dict]:
        epoch = 0
        buf = []
        while self.num_epochs is None or epoch < self.num_epochs:
            produced = 0
            for sample in self.factory():
                produced += 1
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield BatchLoader._collate(buf)
                    buf = []
            if produced == 0:
                raise ValueError("IterBatcher: source iterator produced no samples")
            epoch += 1


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``; to a GPU through pinned memory, without
    blocking the host."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                  else t.to(device))
    return out


def device_prefetch(batches: Iterator[dict], device, size: int = 2) -> Iterator[dict]:
    """Keep ``size`` batches in flight to ``device`` (double buffering by default)."""
    buf = collections.deque()
    for b in batches:
        buf.append(to_device(b, device))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
