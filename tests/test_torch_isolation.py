"""The port and chip_smoke.py run without JAX, Flax, orbax or the JAX package: the GPU
machine has none of them. One child process per main path imports every port module and
drives the path on the CPU through chip_smoke.py: serving, one training step of config 4,
one of config 2 with a validation, and split_training's two phases.

The children run beside the other pytest workers, so each keeps PyTorch to two threads:
one child with every path and PyTorch's default of a thread per core took ~4x its time
alone beside five busy workers."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import tf_depth_estimation_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "orbax", "tf_depth_estimation_tpu")

_PRELUDE = r"""
import importlib, pkgutil, sys
for name in %(forbidden)r:
    sys.modules[name] = None          # any import of it raises ImportError
import torch
torch.set_num_threads(2)
import tf_depth_estimation_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import tempfile
import chip_smoke
from tf_depth_estimation_torch.ops.bilinear_sample import bilinear_sample
from tf_depth_estimation_torch.ops.fused_tail import fused_tail
from tf_depth_estimation_torch.ops.sig_l2 import sig_l2_fused
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused
"""

# path -> the child's body after the prelude; each ends by printing ISOLATED_OK
_PATHS = {
    "serving": r"""
from tf_depth_estimation_torch.utils.npz import load_variables_npz
variables, _ = load_variables_npz(chip_smoke.TEACHER)
fwd = chip_smoke.phase_forward(variables, "cpu", height=64, width=96, batch=2)
served = chip_smoke.phase_serving(variables, "cpu", height=64, width=96, batch=8)
assert fwd["launches"] == 0 and served["frames"] == 14 and fused_tail.launches == 0, (
    fwd, served)
""",
    "optflow_combine": r"""
with tempfile.TemporaryDirectory() as tmp:
    dataset = chip_smoke.write_dataset(tmp, batch=2, read_hw=(48, 96))
    trained = chip_smoke.phase_training("cpu", dataset, height=32, width=64,
                                        read_hw=(48, 96), batch=2, steps=1, dtype="float32")
assert trained["steps"] == 1 and bilinear_sample.launches == 0, trained
assert smoothness_fused.launches == 0
""",
    "depth_only": r"""
with tempfile.TemporaryDirectory() as tmp:
    dataset = chip_smoke.write_dataset(tmp, batch=2, read_hw=(48, 96))
    depth = chip_smoke.phase_depth_only("cpu", dataset, height=48, width=96, batch=2,
                                        steps=1, val_check=1, dtype="float32")
assert depth["validations"] == 1 and smoothness_fused.launches == 0, depth
""",
    # 3 steps a phase: the sig weight ramps over max_steps // 3 steps, which is 0 (a 0/0
    # weight) below 3, in the JAX package as in the port
    "split_training": r"""
with tempfile.TemporaryDirectory() as tmp:
    split = chip_smoke.phase_split_training("cpu", tmp, height=32, width=64, batch=1,
                                            steps=3, dtype="float32")
assert all(split[p]["sig_fwd"] == split[p]["sig_bwd"] == 0 for p in ("pair", "single"))
assert sig_l2_fused.launches == sig_l2_fused.backward_launches == 0, split
""",
}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.dirname(tf_depth_estimation_torch.__file__)):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_port_and_smoke_run_with_jax_blocked(path):
    child = _PRELUDE % {"forbidden": FORBIDDEN} + _PATHS[path] + 'print("ISOLATED_OK")\n'
    out = subprocess.run([sys.executable, "-c", child], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_every_port_module_is_imported_by_the_child():
    names = {m.name for m in pkgutil.walk_packages(tf_depth_estimation_torch.__path__,
                                                   "tf_depth_estimation_torch.")}
    assert {"tf_depth_estimation_torch.ops.fused_tail",
            "tf_depth_estimation_torch.infer.cli",
            "tf_depth_estimation_torch.weights",
            "tf_depth_estimation_torch.ops.bilinear_sample",
            "tf_depth_estimation_torch.geometry.warp",
            "tf_depth_estimation_torch.train.steps",
            "tf_depth_estimation_torch.train.experiments.optflow_combine",
            "tf_depth_estimation_torch.ops.smoothness",
            "tf_depth_estimation_torch.train.experiments.depth_only",
            "tf_depth_estimation_torch.ops.sig_l2",
            "tf_depth_estimation_torch.models.depth_pose",
            "tf_depth_estimation_torch.data.demon",
            "tf_depth_estimation_torch.train.experiments.split_training"} <= names


def test_no_port_file_names_jax_in_an_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(%s)\b" % "|".join(re.escape(f) for f in FORBIDDEN),
        re.MULTILINE)
    files = _port_files()
    assert len(files) > 10
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []
