"""The multi-device dry run: the port of ``__graft_entry__.py:dryrun_multichip``.

``dryrun_multichip(n)`` starts ``n`` processes on the CPU, joined by gloo through a
``FileStore``, and runs on each the three phases of the JAX dry run on a global batch of
2 samples a rank (``run_phases``):
1. one data-parallel step of split_training's pairwise net (the truncated DepthPoseNet,
   ``make_pairwise_step``; its sig term is kernel #3 on the card);
2. one data-parallel distill step: a TurboDepthNet nano student learns the frozen depth4
   teacher (``folded_teacher``, whose tail is kernel #1 on the card);
3. rank 0 saves both states as checkpoint groups, every rank restores them into fresh
   states and checks them, weights, step and Adam's state, bit-equal to the live ones,
   then takes one more data-parallel pairwise step from the restored state, held to the
   live state's next step: equal on the CPU, Adam's moments too; on the card, where
   cuDNN may sum in another order from one run to the next, the loss within 1e-6 and the
   parameters within 2 lr (the moments' gap, ``moment_gap``, is reported: float32
   rounding through train-mode batch norm over 2 samples can move a gradient by
   percents).
Every phase checks that every rank holds the same parameters after its step.
``run_phases`` takes any group, so on one card it runs in-process at world size 1 over
NCCL. ::

    python -m tf_depth_estimation_torch.parallel.dryrun [N]      # N gloo ranks, default 2
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, Union

import numpy as np
import torch
import torch.distributed as dist

from tf_depth_estimation_torch.geometry.camera import (
    make_intrinsics_matrix,
    scale_intrinsics_pyramid,
)
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.parallel.dp import (
    init_process_group,
    is_primary,
    make_dp_step,
    moment_gap,
    same_on_every_rank,
    shard_batch,
)
from tf_depth_estimation_torch.train.checkpoint import CheckpointManager
from tf_depth_estimation_torch.train.distill import folded_teacher, make_distill_step
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_pairwise_step
from tf_depth_estimation_torch.weights import module_variables

H, W = 32, 64            # the pairwise phase (JAX's dry run)
HD, WD = 64, 96          # the distill phase
PER_RANK = 2             # samples of the global batch a rank
_MODULE = "tf_depth_estimation_torch.parallel.dryrun"
# the resumed step's loss against the live one's on the card (see the module's docstring)
TOL_RESUMED_LOSS = 1e-6


def _pair_batch(B: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    K = make_intrinsics_matrix(torch.full((B,), 40.0), torch.full((B,), 40.0),
                               torch.full((B,), W / 2), torch.full((B,), H / 2))
    return {
        "image_pair": rng.rand(B, H, W, 6).astype(np.float32) - 0.5,
        "depth0": rng.uniform(0.5, 2.0, (B, H, W, 1)).astype(np.float32),
        "depth2": rng.uniform(0.5, 2.0, (B, H // 4, W // 4, 1)).astype(np.float32),
        "rotation": (rng.randn(B, 3) * 0.05).astype(np.float32),
        "translation": (rng.randn(B, 3) * 0.1).astype(np.float32),
        "intrinsics": scale_intrinsics_pyramid(K, 4).numpy(),
    }


def _pair_state(device):
    model = DepthPoseNet(full_resolution=False, generator=torch.Generator().manual_seed(0))
    return create_train_state(model.to(device), learning_rate=1e-4)


def _student_state(device):
    model = TurboDepthNet(TurboVariant.nano(), generator=torch.Generator().manual_seed(2))
    return create_train_state(model.to(device), learning_rate=1e-3)


def _finite(metrics: dict, key: str) -> float:
    value = float(metrics[key])
    if not np.isfinite(value):
        raise AssertionError(f"non-finite {key}: {metrics}")
    return value


def _check_replicas(state, group, label: str) -> None:
    if not same_on_every_rank(state, group):
        raise AssertionError(f"{label}: the ranks' parameters differ after the step")


def _same_optimizer_state(a: torch.optim.Optimizer, b: torch.optim.Optimizer) -> bool:
    """Whether two Adams hold the same hyperparameters and, to the bit, the same step
    counts and moments (compared on the host: a restored step count may lie on the
    card where the live one lies on the host)."""
    sa, sb = a.state_dict(), b.state_dict()
    if sa["param_groups"] != sb["param_groups"] or sorted(sa["state"]) != sorted(sb["state"]):
        return False
    host = lambda v: torch.as_tensor(v).cpu()
    return all(sorted(sa["state"][i]) == sorted(sb["state"][i])
               and all(torch.equal(host(v), host(sb["state"][i][k]))
                       for k, v in sa["state"][i].items())
               for i in sa["state"])


def run_phases(group, device: Union[str, torch.device], workdir: str) -> dict:
    """The dry run's three phases on this rank of ``group``; ``workdir`` is the same
    directory on every rank (rank 0 writes the checkpoints there). Returns the global
    metrics of each phase's step; raises where a phase fails."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    device = torch.device(device)
    tensors = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                         for k, v in b.items()}
    out = {"world_size": world}

    w = LossWeights(height=H, width=W, max_steps=100, depth_weight=500.0,
                    cam_weight_rot=160.0, cam_weight_tran=10.0, depth_sig_weight=1000.0)
    batch = tensors(shard_batch(_pair_batch(PER_RANK * world), rank, world))
    state = _pair_state(device)
    dp_step = make_dp_step(make_pairwise_step(w), group)
    state, metrics = dp_step(state, batch)
    out["pairwise_total"] = _finite(metrics, "total")
    if state.step != 1:
        raise AssertionError(f"the pairwise state is at step {state.step}, not 1")
    _check_replicas(state, group, "phase 1")
    if is_primary(group):
        print(f"dryrun_multichip({world}): phase 1 OK (pairwise train step) - "
              f"total={out['pairwise_total']:.4f}", flush=True)

    teacher_vars = module_variables(DispNet(DispNetVariant.depth4(),
                                            generator=torch.Generator().manual_seed(1)))
    teacher = folded_teacher(teacher_vars, dtype=torch.float32, device=device)
    rng = np.random.RandomState(1)
    images = (rng.rand(PER_RANK * world, HD, WD, 3) * 255).astype(np.float32)
    images = torch.from_numpy(shard_batch(images, rank, world)).to(device)
    s_state = _student_state(device)
    s_state, d_metrics = make_dp_step(make_distill_step(teacher), group)(s_state, images)
    out["distill_total"] = _finite(d_metrics, "total_loss")
    _check_replicas(s_state, group, "phase 2")
    if is_primary(group):
        print(f"dryrun_multichip({world}): phase 2 OK (DP distill step) - "
              f"distill_loss={out['distill_total']:.4f}", flush=True)

    model_ckpt = CheckpointManager(workdir, "model")
    turbo_ckpt = CheckpointManager(workdir, "turbo")
    if is_primary(group):
        model_ckpt.save(state.step, state)
        turbo_ckpt.save(s_state.step, s_state)
    dist.barrier(group)
    restored = model_ckpt.restore(_pair_state(device))
    r_turbo = turbo_ckpt.restore(_student_state(device))
    for got, want in ((restored, state), (r_turbo, s_state)):
        a, b = got.model.state_dict(), want.model.state_dict()
        if sorted(a) != sorted(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("a restored state differs from the saved one")
        if got.step != want.step:
            raise AssertionError(f"restored step {got.step}, saved {want.step}")
        if not _same_optimizer_state(got.optimizer, want.optimizer):
            raise AssertionError("a restored optimizer state differs from the saved one")
    restored, metrics2 = dp_step(restored, batch)
    out["resumed_total"] = _finite(metrics2, "total")
    if restored.step != 2:
        raise AssertionError(f"the resumed state is at step {restored.step}, not 2")
    _check_replicas(restored, group, "phase 3")
    # the step the saved state takes without the round trip, from equal states
    state, live = dp_step(state, batch)
    lr = state.optimizer.param_groups[0]["lr"]
    worst = max((p - q).abs().max().item() for p, q in zip(restored.model.parameters(),
                                                          state.model.parameters()))
    rel = abs(float(live["total"]) - out["resumed_total"]) / abs(float(live["total"]))
    gap = moment_gap(restored, state)
    if device.type == "cuda":
        ok = rel <= TOL_RESUMED_LOSS and worst <= 2 * lr * (1 + 1e-4)
    else:
        ok = rel == 0.0 and gap == 0.0 and worst == 0.0
    if not ok:
        raise AssertionError(f"the resumed step differs from the live state's next step: "
                             f"total {out['resumed_total']} vs {float(live['total'])}, "
                             f"first moments {gap} apart, params {worst} apart")
    out["resumed_param_diff"], out["resumed_moment_gap"] = worst, gap
    dist.barrier(group)
    if is_primary(group):
        print(f"dryrun_multichip({world}): phase 3 OK (checkpoint round trip + resumed "
              f"DP step) - total={out['resumed_total']:.4f}", flush=True)
    return out


def _rank_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(2)
    group = init_process_group(workdir, rank, world, "gloo")
    try:
        out = run_phases(group, "cpu", workdir)
        if rank == 0:
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """Run the three phases over ``n_devices`` gloo ranks on the CPU, one process each
    (two PyTorch threads a process); returns rank 0's metrics and raises when a rank
    fails or takes over 10 minutes."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                         if p)}
    with tempfile.TemporaryDirectory() as workdir:
        procs = [subprocess.Popen([sys.executable, "-m", _MODULE, "--rank", str(r),
                                   str(n_devices), "--workdir", workdir],
                                  env=env, cwd=root)
                 for r in range(n_devices)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks exited with {codes}")
        with open(os.path.join(workdir, "result.json")) as f:
            return json.load(f)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--rank", type=int, default=None, help="run one rank (internal)")
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)
    if args.rank is None:
        print(json.dumps(dryrun_multichip(args.n)))
    else:
        _rank_main(args.rank, args.n, args.workdir)


if __name__ == "__main__":
    main()
