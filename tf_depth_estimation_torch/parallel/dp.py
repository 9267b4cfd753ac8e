"""The process group, the rank's shard of a batch and the data-parallel step.

``make_dp_step`` computes what JAX's ``make_dp_step`` computes
(``tf_depth_estimation_tpu/parallel/mesh.py:40-60``): the step of the global batch.
- Batch norm: the step runs inside ``models/layers.py:sync_batch_norm``, so every
  train-mode batch norm normalises by the statistics of the global batch, and the
  gradient flows back through their all-reduce to every rank (sync BN, as XLA's
  partitioned batch norm gives JAX).
- Gradients: after the backward, just before Adam's update (an optimizer step pre-hook),
  the gradients are averaged over the ranks in one all-reduce. The loss of every step the
  port makes data-parallel is a mean over per-sample terms of equal shards, so the mean
  of the ranks' losses is the global loss and the mean of their gradients its gradient.
  No ``DistributedDataParallel`` wrapper is used: the model keeps its own state-dict
  names, which ``weights.py`` and the checkpoints read.
- Metrics: the step's metrics are averaged over the ranks, so every rank returns the
  global batch's metrics, which rank 0 logs as JAX logs them.
``make_dp_step`` takes train steps only, ``(state, batch) -> (state, metrics)``: a
validation step returns its metrics alone and steps no optimizer. Config 2's validation
also carries ``not_data_parallel`` (``depth_only_val_loss``'s ``si_log_rmse`` is a square
root of means, not a mean over equal shards), which ``make_dp_step`` refuses by name.

Only rank 0 writes checkpoints (``is_primary``). The group is set up over a ``FileStore``
in a given directory, not a TCP port, so runs on one machine never collide on a port.
"""
from __future__ import annotations

import os
from typing import Callable, List, Union

import torch
import torch.distributed as dist

from tf_depth_estimation_torch.models.layers import sync_batch_norm


def init_process_group(store_dir: str, rank: int, world_size: int, backend: str = "gloo"):
    """Join the default process group of ``world_size`` ranks through a ``FileStore`` at
    ``<store_dir>/store`` (every rank passes the same directory, which must be empty of
    an earlier run's store). ``backend``: "gloo" on the CPU, "nccl" on the card (each
    rank on ``cuda:<rank>``). Returns the group."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return dist.group.WORLD


def is_primary(group=None) -> bool:
    """Rank 0 of ``group``, the one that logs and writes checkpoints (True without a
    process group)."""
    return not dist.is_initialized() or dist.get_rank(group) == 0


def replica_devices(device: Union[str, torch.device], num_devices: int) -> List[torch.device]:
    """The devices of ``num_devices`` replicas from ``device`` on: ``cuda:i .. i+n-1``,
    raising as JAX's ``make_mesh`` raises when the machine has fewer
    (``parallel/mesh.py:19-21`` there); on the CPU the replicas share it and run in turn."""
    device = torch.device(device)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if device.type != "cuda":
        return [device] * num_devices
    first = device.index or 0
    have = torch.cuda.device_count()
    if first + num_devices > have:
        raise ValueError(f"requested {num_devices} devices from cuda:{first}, have {have}")
    return [torch.device("cuda", first + i) for i in range(num_devices)]


def shard_batch(batch, rank: int, world_size: int):
    """The rank's contiguous slice of the leading (batch) axis of a batch (a dict of
    tensors or arrays, or one of them); raises when the batch does not divide evenly, as
    a ``NamedSharding`` over the data axis does."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world_size) for k, v in batch.items()}
    n = batch.shape[0]
    if n % world_size:
        raise ValueError(f"a batch of {n} does not divide over {world_size} ranks")
    b = n // world_size
    return batch[rank * b:(rank + 1) * b]


def _mean_(flat: torch.Tensor, group) -> torch.Tensor:
    """In-place mean of ``flat`` over the group: NCCL averages in the all-reduce (on one
    rank as its one-rank reduce kernel), gloo, which has no average, sums and this
    divides."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(dist.get_world_size(group))
    return flat


def average_gradients(optimizer: torch.optim.Optimizer, group=None) -> None:
    """Replace every gradient of ``optimizer``'s parameters by its mean over the group,
    in one all-reduce of the gradients laid end to end."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    if not grads:
        return
    flat = _mean_(torch.cat([g.reshape(-1).float() for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_mean(metrics: dict, group=None) -> dict:
    """The metrics (0-d tensors or floats) averaged over the group, as detached 0-d
    float32 tensors, in one all-reduce."""
    keys = sorted(metrics)
    device = next((v.device for v in metrics.values() if torch.is_tensor(v)), None)
    flat = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device)
                        .detach().reshape(()) for k in keys])
    flat = _mean_(flat, group)
    return dict(zip(keys, flat.unbind()))


def make_dp_step(step_fn: Callable, group=None) -> Callable:
    """Wrap a port train step ``(state, batch, *extras) -> (state, metrics)``
    (``train/steps.py``, ``train/distill.py``) into the step of the global batch, of which
    each rank passes its shard (``shard_batch``): synced batch statistics, gradients
    averaged before Adam's update, metrics averaged. Every rank holds the same state
    before and after. A step marked ``not_data_parallel`` raises."""
    reason = getattr(step_fn, "not_data_parallel", None)
    if reason:
        raise ValueError(f"this step cannot be made data-parallel: {reason}")

    def dp_step(state, batch, *extras):
        hook = state.optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: average_gradients(opt, group))
        try:
            with sync_batch_norm(group):
                state, metrics = step_fn(state, batch, *extras)
        finally:
            hook.remove()
        return state, all_reduce_mean(metrics, group)

    return dp_step


def same_on_every_rank(state, group=None) -> bool:
    """Whether every rank holds the same parameters, to the bit (the invariant of a
    data-parallel run): each rank's parameters' checksum against rank 0's."""
    flat = torch.cat([p.detach().reshape(-1).double() for p in state.model.parameters()])
    mine = torch.stack([flat.sum(), (flat * flat).sum(), flat.abs().max()])
    ref = mine.clone()
    dist.broadcast(ref, 0, group=group)
    return bool(torch.equal(mine, ref)) and bool(torch.isfinite(mine).all())


def moment_gap(state, ref) -> float:
    """How far Adam's first moments (``exp_avg``; after the first update ``(1 - beta1)``
    times the gradient) of ``state`` lie from those of ``ref``, a state of the same model:
    the largest over parameters of ``max|m - m_ref| / max|m_ref|``. It checks the
    gradients a step applied, where the parameters cannot: Adam's first update moves
    every parameter by about lr whatever its gradient."""
    a, b = state.optimizer.state, ref.optimizer.state
    worst = 0.0
    for p, q in zip(state.model.parameters(), ref.model.parameters()):
        if p not in a and q not in b:   # a parameter no loss reaches has no moments
            continue
        m, m_ref = a[p]["exp_avg"], b[q]["exp_avg"]
        scale = m_ref.float().abs().max().clamp_min(1e-30)
        worst = max(worst, ((m.float() - m_ref.float()).abs().max() / scale).item())
    return worst
