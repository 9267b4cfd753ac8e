"""Checkpoints of the PyTorch port: flat ``.npz`` weights plus the optimizer state.

``CheckpointManager(directory, group).save(step, state)`` writes ``<group>-<step>.npz``,
the ``{params, batch_stats}`` tree in the serving format of ``utils/npz.py`` (which the
JAX package's ``load_variables_npz`` reads), stored rather than deflated, and
``<group>-<step>.opt.pt``, Adam's state and the step for ``--continue_train``. The group
names the model, as the JAX package's named checkpoint groups do
(``train/checkpoint.py``): ``model`` by default, and ``model_pairdepth`` and
``model_singledepth`` for split_training's two phases (``split_training.py:147,338``).
The newest ten steps of a group are kept, as the JAX package's manager keeps.
``load_latest_variables(directory, group)`` reads the newest step's weights alone, for the
distillation teacher and the serving CLI; it needs no ``.opt.pt``. The JAX package's orbax
directories are not ported.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from tf_depth_estimation_torch.train.state import TrainState
from tf_depth_estimation_torch.utils.npz import load_variables_npz, save_variables_npz


MAX_TO_KEEP = 10


def _steps(directory: str, group: str) -> List[int]:
    found = (re.fullmatch(rf"{re.escape(group)}-(\d+)\.npz", os.path.basename(p))
             for p in glob.glob(os.path.join(directory, f"{group}-*.npz")))
    return sorted(int(m.group(1)) for m in found if m)


def load_latest_variables(directory: str, group: str = "model"
                          ) -> Tuple[Dict[str, Any], int]:
    """``(variables, step)`` of the newest ``<group>-<step>.npz`` in ``directory``, the
    weights alone; raises ``FileNotFoundError`` naming the directory and group when there
    is none."""
    steps = _steps(os.path.abspath(directory), group)
    if not steps:
        raise FileNotFoundError(f"no {group}-<step>.npz checkpoint in {directory}")
    variables, _ = load_variables_npz(os.path.join(directory, f"{group}-{steps[-1]}.npz"))
    return variables, steps[-1]


class CheckpointManager:
    def __init__(self, directory: str, group: str = "model"):
        self.directory = os.path.abspath(directory)
        self.group = group
        os.makedirs(self.directory, exist_ok=True)

    def weights_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.group}-{step}.npz")

    def steps(self) -> List[int]:
        return _steps(self.directory, self.group)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> str:
        """Write step ``step``; returns the ``.npz`` path."""
        path = self.weights_path(step)
        torch.save({"step": step, "optimizer": state.optimizer.state_dict()},
                   path[:-len(".npz")] + ".opt.pt")
        save_variables_npz(path, state.variables(), step=step)
        for old in self.steps()[:-MAX_TO_KEEP]:
            for p in (self.weights_path(old), self.weights_path(old)[:-4] + ".opt.pt"):
                if os.path.exists(p):
                    os.remove(p)
        return path

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step ``step`` (default: the newest) into ``state``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        variables, _ = load_variables_npz(self.weights_path(step))
        state.load_variables(variables)
        opt = torch.load(self.weights_path(step)[:-4] + ".opt.pt",
                         map_location=next(state.model.parameters()).device)
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = int(opt["step"])
        return state
