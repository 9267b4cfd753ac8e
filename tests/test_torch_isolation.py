"""The port and chip_smoke.py run without JAX, Flax, orbax or the JAX package: the GPU
machine has none of them. One child process per main path imports every port module and
drives the path on the CPU through chip_smoke.py: serving, one training step of config 4,
one of config 2 with a validation, split_training's two phases, one step of config 3 with
the eval harness's two nets, pair serving of the full-resolution and the truncated
DepthPoseNet, the nine TurboDepthNet presets' folded forward and turbo serving, the
tensor-core probes' plain versions (the probes' entry points refuse to run without a card),
distillation with its step parity and the device cache, ``depth_only --turbo`` with
depth serving from a checkpoint directory and through the module forward, and the
DeMoN-stream families: config 5 with its checkpoint served, and both L/R modes, and the
colon-pair families: optflow_family's five modes and dim11, with the sfm checkpoint
served through the module forward; and refinement against a COLMAP model through its CLI
and flow-augmented serving (in the pair-serving child).

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
import numpy as np
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
    # config 4, then the colon-pair families on the same pairs (and dim11's layout): on
    # the CPU every warp is a plain sampling (4 a step in only_image, optflow_only, sfm
    # and dim11), and no kernel launches
    "optflow_combine": r"""
with tempfile.TemporaryDirectory() as tmp:
    dataset = chip_smoke.write_dataset(tmp, batch=2, read_hw=(48, 96))
    trained = chip_smoke.phase_training("cpu", dataset, height=32, width=64,
                                        read_hw=(48, 96), batch=2, steps=1, dtype="float32")
    assert trained["steps"] == 1 and bilinear_sample.launches == 0, trained
    assert smoothness_fused.launches == 0
    d11, depth_dir = chip_smoke.write_dim11_dataset(tmp, batch=2, hw=(32, 64))
    for mode in chip_smoke.COLON_MODES:
        run = chip_smoke.phase_colon("cpu", tmp, mode, d11 if mode == "dim11" else dataset,
                                     depth_dir=depth_dir if mode == "dim11" else None,
                                     height=32, width=64, read_hw=(48, 96), batch=2,
                                     steps=1, dtype="float32")
        n = run["per_step"][0]
        assert n["plain_samples"] == chip_smoke.COLON_WARPS[mode] and not any(
            v for k, v in n.items() if k != "plain_samples"), (mode, n)
        assert run["groups"] == [(chip_smoke.COLON_SMOOTH_MAPS[mode],) * 2], run["groups"]
        if mode == "sfm":
            chip_smoke.reset_counts()
            served = chip_smoke.phase_sfm_serving("cpu", run["variables"], height=32,
                                                  width=64, batch=8)
            assert served["frames"] == 28 and not any(chip_smoke.read_counts().values())
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
    # on the CPU the fused sampler is the plain version: 4 plain samplings a step
    "depth_then_cam": r"""
with tempfile.TemporaryDirectory() as tmp:
    c3 = chip_smoke.phase_depth_then_cam("cpu", tmp, height=32, width=64, batch=2, steps=1,
                                         dtype="float32")
    evals = chip_smoke.phase_eval_harness("cpu", tmp, c3["variables"], height=32, width=64,
                                          batch=2, n=1, dtype="float32")
assert [(n["fused_fwd"], n["fused_bwd"], n["bilinear_sample"], n["plain_samples"],
         n["smoothness_fwd"]) for n in c3["per_step"]] == [(0, 0, 0, 4, 0)], c3["per_step"]
assert all(c["sig_fwd"] == 0 and np.isfinite(m["total"]) for m, c in evals.values()), evals
""",
    # the full-resolution net (config 3's) and the truncated one (the pair CLI's)
    "pair_serving": r"""
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.weights import state_dict_to_variables
for full in (True, False):
    variables = state_dict_to_variables(DepthPoseNet(
        full_resolution=full, generator=torch.Generator().manual_seed(0)).state_dict())
    served = chip_smoke.phase_pair_serving("cpu", variables, height=32, width=64, batch=2,
                                          dtype=torch.float32)
    assert served["frames_per_s"] > 0 and fused_tail.launches == 0, served
# refinement through its CLI (on the CPU both sampler routes are the plain version: 4 plain
# samplings a step, no launch) and the flow-augmented predictor, at 32x48
with tempfile.TemporaryDirectory() as tmp:
    rf = chip_smoke.phase_refine("cpu", tmp, hw=(32, 48), points=8, steps=2)
chip_smoke._check_per_step("refinement", rf["per_step"],
                           {"plain_samples": chip_smoke.RF_WARPS})
assert rf["groups"] == [(4, 4)] * 2, rf["groups"]
chip_smoke.phase_refine_parity("cpu", "", hw=(32, 48))
flow = chip_smoke.phase_flow_serving("cpu", hw=(32, 48), batch=2)
assert flow["frames_per_s"] > 0 and not any(flow["counts"].values()), flow
""",
    "turbo_serving": r"""
small = lambda name: (48, 96) if name == "colon" else (64, 96)
worst = chip_smoke.phase_turbo_parity("cpu", hw=small)
served = chip_smoke.phase_turbo_serving("cpu", height=64, width=96, batch=8, bench_batch=8)
assert sorted(worst) == sorted(chip_smoke.TurboVariant.PRESETS) and served["frames"] == 14
assert not any(chip_smoke.read_counts().values()), chip_smoke.read_counts()
""",
    # the teacher's fused tail is its plain version on the CPU: no launch
    "distill": r"""
with tempfile.TemporaryDirectory() as tmp:
    dist = chip_smoke.phase_distill("cpu", tmp, height=64, width=96, batch=2, steps=2,
                                    val_check=1, variant="small", dtype="float32")
assert dist["validations"] == 2 and dist["served"] == 3 and not any(
    dist["counts"].values()), dist
chip_smoke.phase_distill_parity("cpu", height=64, width=96, batch=2, variant="small")
cache = chip_smoke.phase_device_cache("cpu", n=6, height=16, width=24, batch=4)
assert cache["nbytes"] == 6 * 16 * 24 * 3 and cache["ms"] is None, cache
""",
    "depth_only_turbo": r"""
variables, _ = chip_smoke.load_variables_npz(chip_smoke.TEACHER)
with tempfile.TemporaryDirectory() as tmp:
    dataset = chip_smoke.write_dataset(tmp, batch=2, read_hw=(48, 144))
    c2t = chip_smoke.phase_depth_only_turbo("cpu", dataset, height=48, width=144, batch=2,
                                            steps=2, val_check=1, dtype="float32")
    depth = chip_smoke.phase_depth_only("cpu", dataset, height=48, width=144, batch=2,
                                        steps=1, val_check=1, dtype="float32")
    served = chip_smoke.phase_depth_checkpoint_serving(
        "cpu", depth["checkpoint"], height=48, width=144, batch=2, n=3, dtype="float32")
module = chip_smoke.phase_serving(variables, "cpu", height=64, width=96, batch=8,
                                  use_fast=False)
assert c2t["validations"] == 2 and c2t["served"] == 3 and served["batches"] == 2, (c2t,
                                                                                 served)
assert module["frames"] == 14 and not any(c2t["counts"].values()), c2t
""",
    # config 5 and both L/R modes; on the CPU the sampler is its plain version (16
    # samplings a step) and the loss terms theirs: no launch
    "demon_stream": r"""
with tempfile.TemporaryDirectory() as tmp:
    c5 = chip_smoke.phase_on_demon("cpu", tmp, height=32, width=64, batch=2, steps=1,
                                   dtype="float32")
    served = chip_smoke.phase_pair_serving("cpu", c5["variables"], height=32, width=64,
                                           batch=2, dtype=torch.float32)
    lr = {m: chip_smoke.phase_lr("cpu", tmp, m, height=32, width=64, batch=2, steps=1,
                                 dtype="float32") for m in chip_smoke.LR_MODES}
assert served["frames_per_s"] > 0 and not any(c5["per_step"][0].values()), c5["per_step"]
for m, run in lr.items():
    n = run["per_step"][0]
    assert n["plain_samples"] == 16 and not any(v for k, v in n.items()
                                                if k != "plain_samples"), (m, n)
""",
    # on the CPU the wrappers run their plain versions; the probes have no CPU path
    "dot_probes": r"""
from tf_depth_estimation_torch.tools import (dot_variants, probe_int8_dot, probe_int8_dot2,
                                             tail_variants)
errs = chip_smoke.phase_probes("cpu", {"dot_loop": (64, 128, 64, 3),
                                       "dot_grid": (128, 64, 256, 1)})
assert set(errs.values()) == {0.0}, errs
for probe in (probe_int8_dot, probe_int8_dot2, dot_variants, tail_variants):
    try:
        probe.main()
    except SystemExit as e:
        assert "NVIDIA GPU" in str(e), e
    else:
        raise AssertionError("a probe ran without a card")
assert chip_smoke.read_counts()["dot_loop"] == chip_smoke.read_counts()["dot_grid"] == 0
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
            "tf_depth_estimation_torch.train.experiments.split_training",
            "tf_depth_estimation_torch.ops.bilinear_sample_fused",
            "tf_depth_estimation_torch.train.experiments.depth_then_cam",
            "tf_depth_estimation_torch.train.experiments.eval_harness",
            "tf_depth_estimation_torch.infer.fast_pose",
            "tf_depth_estimation_torch.models.turbo",
            "tf_depth_estimation_torch.infer.fast_turbo",
            "tf_depth_estimation_torch.ops.dot_loop",
            "tf_depth_estimation_torch.ops.dot_grid",
            "tf_depth_estimation_torch.tools.probe_int8_dot",
            "tf_depth_estimation_torch.tools.probe_int8_dot2",
            "tf_depth_estimation_torch.train.distill",
            "tf_depth_estimation_torch.train.experiments.distill_turbo",
            "tf_depth_estimation_torch.data.device_cache",
            "tf_depth_estimation_torch.data.demon_v1",
            "tf_depth_estimation_torch.models.composite",
            "tf_depth_estimation_torch.train.experiments.on_demon",
            "tf_depth_estimation_torch.train.experiments.depth_then_cam_lr",
            "tf_depth_estimation_torch.train.experiments.optflow_family",
            "tf_depth_estimation_torch.train.experiments.dim11",
            "tf_depth_estimation_torch.colmap.io",
            "tf_depth_estimation_torch.colmap.scene_manager",
            "tf_depth_estimation_torch.infer.refine",
            "tf_depth_estimation_torch.infer.refine_cli",
            "tf_depth_estimation_torch.models.upconv",
            "tf_depth_estimation_torch.data.manifest"} <= names


def test_no_port_file_names_jax_in_an_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(%s)\b" % "|".join(re.escape(f) for f in FORBIDDEN),
        re.MULTILINE)
    files = _port_files()
    assert len(files) > 10
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []
