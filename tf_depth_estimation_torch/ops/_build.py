"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own shared library
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout; the hash covers the
source, the headers of ``csrc/`` (``*.cuh``) and the flags, so an edited source or header
builds anew and an unchanged one loads at once.
No source includes PyTorch's headers: with them one small file took minutes to compile,
without them seconds. ``build_all`` starts one ``nvcc`` for each source of ``KERNELS``,
all at once. Everything here runs at first use, never at import.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every source of csrc/, by name
KERNELS = ("fused_tail", "bilinear_sample", "smoothness", "sig_l2", "dot_loop", "dot_grid")

# name -> {"lib": ctypes.CDLL, "path": the .so, "seconds": nvcc wall time (0 if cached),
#          "log": nvcc output}
_LOADED: Dict[str, dict] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of tf_depth_estimation_torch are built on the GPU machine")
    return found


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is built already, and load it.

    Returns ``{"lib", "path", "seconds", "log"}``: the library and its file, nvcc's wall
    time (0 when the library was cached) and nvcc's output, which holds the ``-Xptxas -v``
    lines."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    target = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *FLAGS, "-o", tmp, src], capture_output=True,
                              text=True)
        seconds, log = time.perf_counter() - t0, proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, target)
    _LOADED[name] = {"lib": ctypes.CDLL(target), "path": target, "seconds": seconds,
                     "log": log}
    return _LOADED[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return build(name)["lib"]


def build_all() -> Dict[str, dict]:
    """``build`` every kernel of ``KERNELS``, one ``nvcc`` for each, all started
    together; returns name -> ``build``'s entry."""
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        return dict(zip(KERNELS, ex.map(build, KERNELS)))
