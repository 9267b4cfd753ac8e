"""What the tensor-core probes and the kernel variant tools share: the card check, the
inputs, the timing, the library yardstick and the build of patched kernel sources."""
from __future__ import annotations

import functools
import os
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def require_cuda() -> str:
    """The card's line (torch's name, and nvidia-smi's name and power limit); raises
    ``SystemExit`` without a CUDA device: the probes measure the card and have no CPU
    path."""
    if not torch.cuda.is_available():
        raise SystemExit("this probe measures an NVIDIA GPU; torch.cuda.is_available() is "
                         "False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return f"{torch.cuda.get_device_name(0)} (nvidia-smi: {smi[0] if smi else 'n/a'})"


def inputs(M: int, K: int, N: int, device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX probes' operands: ``RandomState(0)``, int8 A and B in [-127, 127], then
    bf16 A and B from ``rand`` (rounded to nearest even, as ``jnp.asarray`` rounds)."""
    rng = np.random.RandomState(0)
    a8 = rng.randint(-127, 128, (M, K), dtype=np.int8)
    b8 = rng.randint(-127, 128, (K, N), dtype=np.int8)
    abf = rng.rand(M, K).astype(np.float32)
    bbf = rng.rand(K, N).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(device)
    return {"a8": t(a8), "b8": t(b8), "abf": t(abf).to(torch.bfloat16),
            "bbf": t(bbf).to(torch.bfloat16)}


def time_2arg(f: Callable, a: torch.Tensor, b: torch.Tensor, n: int = 8,
              trials: int = 5) -> float:
    """The JAX probes' method: best of ``trials`` windows of ``n`` calls on the host
    clock, each window ended by reading the last call's scalar back (seconds a call)."""
    s = float(f(a, b))
    assert np.isfinite(s), "non-finite output"
    best = 1e30
    for _ in range(trials):
        t0 = time.time()
        for _ in range(n):
            out = f(a, b)
        _ = float(out)  # host readback forces completion
        best = min(best, (time.time() - t0) / n)
    return best


@functools.lru_cache(maxsize=None)
def library_product(dtype: torch.dtype) -> Tuple[Callable, str]:
    """(a . b by one PyTorch call, its label): the yardstick the probes time beside the
    kernels, never called by the port. int8: ``torch._int_mm`` (int32, the same function).
    bf16: ``torch.mm(..., out_dtype=torch.float32)`` where the installed torch has it,
    else bf16 ``torch.matmul``, which rounds the output to bf16."""
    if dtype == torch.int8:
        return torch._int_mm, "torch._int_mm"
    x = torch.ones((16, 16), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(x, x, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return torch.matmul, "torch.matmul (bf16 output)"
    return (lambda a, b: torch.mm(a, b, out_dtype=torch.float32),
            "torch.mm(out_dtype=float32)")


def best_ms(call: Callable, iters: int = 10, windows: int = 5) -> float:
    """Best of ``windows`` CUDA-event windows of ``iters`` calls (ms a call), after one
    window that warms up."""
    best = float("inf")
    for w in range(windows + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        if w:
            best = min(best, start.elapsed_time(end) / iters)
    return best


def build_variant(kernel: str, patches: List[Tuple[str, str, str]], directory: str) -> str:
    """Copy the headers of ``csrc/`` and ``csrc/<kernel>.cu`` into ``directory``, replace
    each ``(file, old text, new text)`` of ``patches`` (raising where the text is gone),
    and build the copy with the port's flags; returns the library's path."""
    from tf_depth_estimation_torch.ops import _build

    os.makedirs(directory, exist_ok=True)
    names = [f for f in sorted(os.listdir(_build.CSRC)) if f.endswith(".cuh")]
    texts = {f: open(os.path.join(_build.CSRC, f)).read() for f in (*names, f"{kernel}.cu")}
    for f, old, new in patches:
        if old not in texts[f]:
            raise RuntimeError(f"{kernel}: {f} no longer holds {old!r}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        with open(os.path.join(directory, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(directory, f"{kernel}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-o", lib,
                           os.path.join(directory, f"{kernel}.cu")], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory}:\n{proc.stdout}{proc.stderr}")
    return lib
