"""One rank of ``tests/test_torch_parallel.py``'s process group (gloo, a ``FileStore``):
the data-parallel config-2 step from the test's init and global batch (its variables and
Adam's first moments), the same step computed in float64 (its first moments), the refusal
of the validation step, and the dry run's three phases; rank 0 writes the results. Imports
no JAX. ::

    python tests/torch_dp_worker.py RANK WORLD WORKDIR
"""
import copy
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.parallel import init_process_group, make_dp_step, shard_batch
from tf_depth_estimation_torch.parallel.dryrun import run_phases
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_only_step, make_depth_only_val_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import module_variables


def first_moments(state) -> dict:
    """Adam's first moments (``exp_avg``) of ``state``'s parameters under JAX's flattened
    parameter names and layouts (those of optax's ``mu``): the moments take the place of
    the parameters in a copy of the model."""
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), state.model.parameters()):
            p.copy_(state.optimizer.state[q]["exp_avg"])
    return _flatten(module_variables(model)["params"])


def main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "cfg.json")) as f:
        cfg = json.load(f)
    group = init_process_group(workdir, rank, world, "gloo")
    try:
        init = load_variables_npz(os.path.join(workdir, "init.npz"))[0]
        with np.load(os.path.join(workdir, "batch.npz")) as f:
            batch = shard_batch({k: torch.from_numpy(f[k]) for k in f.files}, rank, world)
        w = dataclasses.replace(LossWeights.depth_only(), height=cfg["height"],
                                width=cfg["width"])
        dp_step = make_dp_step(make_depth_only_step(w), group)
        states = {}
        for dtype in (torch.float64, torch.float32):
            state = create_train_state(DispNet(DispNetVariant.depth4(), dtype=dtype),
                                       learning_rate=cfg["lr"])
            state.load_variables(init)
            states[dtype], metrics = dp_step(state, batch)
        state = states[torch.float32]   # the metrics are the float32 step's
        try:
            make_dp_step(make_depth_only_val_step(w), group)
            refused = False
        except ValueError:
            refused = True
        out = {"metrics": {k: float(v) for k, v in metrics.items()}, "step": state.step,
               "val_refused": refused}
        if rank == 0:
            save_variables_npz(os.path.join(workdir, "dp.npz"), state.variables())
            np.savez(os.path.join(workdir, "dp_mu.npz"), **first_moments(state))
            np.savez(os.path.join(workdir, "dp_mu64.npz"),
                     **first_moments(states[torch.float64]))
        dryrun_dir = os.path.join(workdir, "dryrun")
        os.makedirs(dryrun_dir, exist_ok=True)
        out["dryrun"] = run_phases(group, "cpu", dryrun_dir)
        if rank == 0:
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(out, f)
        dist.barrier(group)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
