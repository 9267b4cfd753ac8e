"""The C++ loader (``native/fastloader.cc``) through ``ctypes``: the port of
``tf_depth_estimation_tpu/data/native.py``.

The C++ core runs the byte-heavy path, JPEG decode (libjpeg), the TF1-parity bilinear
resize and the raw float32 depth reads, on worker threads outside the GIL, and hands whole
fixed-shape samples back through a bounded ring buffer; Python keeps the text parsing
(intrinsics and projection files) and the batching.

The library is built from the checkout's ``native/fastloader.cc`` at first use, with
``g++`` and the flags of ``native/Makefile`` but ``-march=native`` (a library built for
one host's instruction set can stop with an illegal instruction on another), into
``build/native/fastloader-<hash>.so``; the hash covers the source and the flags, so an
edited source builds anew. The ``native/libfastloader.so`` committed beside the source is
never loaded. ``available()`` is False where the library cannot build or load (no
``g++``, no libjpeg, no source); ``build_error()`` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "fastloader.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
LDFLAGS = ["-ljpeg", "-lpthread"]

# {"lib", "path", "seconds", "log"} once built and loaded; {"error": str} once failed
_STATE: dict = {}


def build() -> dict:
    """Compile ``native/fastloader.cc`` unless its library is built already, and load it.
    Returns ``{"lib", "path", "seconds", "log"}`` (``seconds`` 0 when cached); raises
    ``RuntimeError`` where it cannot build."""
    if "lib" in _STATE:
        return _STATE
    if "error" in _STATE:
        raise RuntimeError(_STATE["error"])
    try:
        _STATE.update(_build())
    except (RuntimeError, OSError) as e:
        _STATE["error"] = str(e)
        raise RuntimeError(_STATE["error"]) from e
    return _STATE


def _build() -> dict:
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"the C++ loader's source {SOURCE} is not in this checkout")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the C++ loader needs g++ (or $CXX) to build")
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    target = os.path.join(BUILD_DIR, f"fastloader-{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXXFLAGS, SOURCE, "-o", tmp, *LDFLAGS],
                              capture_output=True, text=True)
        seconds, log = time.perf_counter() - t0, proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on native/fastloader.cc (libjpeg's jpeglib.h "
                               f"and -ljpeg are needed):\n{log}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(target)
    lib.fastloader_create.restype = ctypes.c_void_p
    lib.fastloader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fastloader_next.restype = ctypes.c_long
    lib.fastloader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_float)]
    lib.fastloader_destroy.argtypes = [ctypes.c_void_p]
    return {"lib": lib, "path": target, "seconds": seconds, "log": log}


def available() -> bool:
    """Whether the C++ loader builds and loads here (building it at the first call)."""
    try:
        build()
    except RuntimeError:
        return False
    return True


def build_error() -> Optional[str]:
    """Why the loader could not build, or None."""
    return _STATE.get("error")


def native_sample_stream(image_paths: Sequence[str], depth_paths: Sequence[str], *,
                         out_hw: Tuple[int, int], depth_hw: Tuple[int, int],
                         order: Optional[np.ndarray] = None, num_threads: int = 4,
                         queue_cap: int = 16) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yields (dataset index, image [h, w, 3] float32, depth [dh, dw] float32) in the
    pipeline's order; an unreadable sample is skipped."""
    lib = build()["lib"]
    n = len(image_paths)
    if len(depth_paths) != n:
        raise ValueError(f"{n} images, {len(depth_paths)} depths")
    order = np.arange(n, dtype=np.int64) if order is None else np.asarray(order, np.int64)
    img_blob = b"\0".join(p.encode() for p in image_paths) + b"\0"
    dep_blob = b"\0".join(p.encode() for p in depth_paths) + b"\0"
    out_h, out_w = out_hw
    dep_h, dep_w = depth_hw
    handle = lib.fastloader_create(img_blob, dep_blob, n,
                                   order.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                                   out_h, out_w, dep_h, dep_w, num_threads, queue_cap)
    try:
        img_buf = np.empty((out_h, out_w, 3), np.float32)
        dep_buf = np.empty((dep_h, dep_w), np.float32)
        for _ in range(len(order)):
            idx = lib.fastloader_next(handle,
                                      img_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                      dep_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if idx == -1:
                break
            if idx == -2:
                continue  # unreadable: skipped, as the reference's queue runners move on
            yield int(idx), img_buf.copy(), dep_buf.copy()
    finally:
        lib.fastloader_destroy(handle)


class NativePairSampler:
    """The samples of a ``data/colon.py:PairDepthDataset``, the packed pair JPEG and the
    depth decoded by the C++ loader, the text fields read here.

    With ``num_threads > 1`` samples arrive in completion order, not index order (as the
    reference's TF queue runners deliver them): every readable sample comes exactly once
    an iteration, but the order is deterministic only with one thread. Each iteration
    reshuffles (``shuffle``) with its own ``RandomState(seed)``."""

    def __init__(self, dataset, num_threads: int = 4, seed: int = 0, shuffle: bool = True):
        self.ds = dataset
        self.num_threads = num_threads
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle

    def __iter__(self):
        from tf_depth_estimation_torch.data.colon import _resize_area_np

        ds = self.ds
        order = np.arange(len(ds), dtype=np.int64)
        if self.shuffle:
            self.rng.shuffle(order)
        stream = native_sample_stream(
            [e["image"] for e in ds.entries], [e["depth"] for e in ds.entries],
            out_hw=(ds.resized_height, ds.resized_width * 2),
            depth_hw=(ds.image_height, ds.image_width), order=order,
            num_threads=self.num_threads)
        for idx, packed, depth in stream:
            e = ds.entries[idx]
            label = _resize_area_np(depth[..., None], (ds.resized_height, ds.resized_width))
            K = np.loadtxt(e["cam"], delimiter=",", dtype=np.float32).reshape(3, 3)
            with open(e["proj"]) as f:
                tokens = np.array(f.read().split(), dtype=np.float32)[:34]
            yield {
                "tgt_image": np.ascontiguousarray(packed[:, :ds.resized_width]),
                "src_image": np.ascontiguousarray(packed[:, ds.resized_width:]),
                "label": label.astype(np.float32),
                "intrinsics": ds.intrinsics_pyramid(K),
                "tgt2src_projs": tokens[:32].reshape(2, 4, 4),
                "m_scale": np.float32(tokens[32]),
            }
