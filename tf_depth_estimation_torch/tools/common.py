"""What the tensor-core probes share: the card check, the inputs, the timing and the
library yardstick."""
from __future__ import annotations

import functools
import subprocess
import time
from typing import Callable, Dict, Tuple

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
