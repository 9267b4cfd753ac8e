"""The port and chip_smoke.py run without JAX, Flax, orbax or the JAX package: the GPU
machine has none of them. The child imports every port module, serves, runs one CPU
training step of config 4 and one of config 2, with a validation, through the CLIs."""
import os
import pkgutil
import re
import subprocess
import sys

import tf_depth_estimation_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "orbax", "tf_depth_estimation_tpu")

_CHILD = r"""
import importlib, pkgutil, sys
for name in %(forbidden)r:
    sys.modules[name] = None          # any import of it raises ImportError
import tf_depth_estimation_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import tempfile
import chip_smoke
from tf_depth_estimation_torch.ops.bilinear_sample import bilinear_sample
from tf_depth_estimation_torch.ops.smoothness import smoothness_fused
from tf_depth_estimation_torch.utils.npz import load_variables_npz
variables, _ = load_variables_npz(chip_smoke.TEACHER)
fwd = chip_smoke.phase_forward(variables, "cpu", height=64, width=96, batch=2)
served = chip_smoke.phase_serving(variables, "cpu", height=64, width=96, batch=8)
assert fwd["launches"] == 0 and served["frames"] == 14, (fwd, served)
with tempfile.TemporaryDirectory() as tmp:
    dataset = chip_smoke.write_dataset(tmp, batch=2, read_hw=(48, 96))
    trained = chip_smoke.phase_training("cpu", dataset, height=32, width=64,
                                        read_hw=(48, 96), batch=2, steps=1, dtype="float32")
    depth = chip_smoke.phase_depth_only("cpu", dataset, height=48, width=96, batch=2,
                                        steps=1, val_check=1, dtype="float32")
assert trained["steps"] == 1 and bilinear_sample.launches == 0, trained
assert depth["validations"] == 1 and smoothness_fused.launches == 0, depth
print("ISOLATED_OK")
"""


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.dirname(tf_depth_estimation_torch.__file__)):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_and_smoke_run_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _CHILD % {"forbidden": FORBIDDEN}], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
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
            "tf_depth_estimation_torch.train.experiments.depth_only"} <= names


def test_no_port_file_names_jax_in_an_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(%s)\b" % "|".join(re.escape(f) for f in FORBIDDEN),
        re.MULTILINE)
    files = _port_files()
    assert len(files) > 10
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []
