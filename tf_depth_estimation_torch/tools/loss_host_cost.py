"""Where the host's time goes in a loss group's call, on the card: host-clock microseconds
a call (``time.perf_counter`` over 200 calls after 10, then a synchronise; the enqueue
and the wall time) of

  * the group wrapper's pieces for config 4's twelve smoothness maps (B=10, 224x480 down
    to 28x60): the checks, the descriptors' packing, the stream query, one launch each
    way through ctypes, and the twelve gradient views;
  * groups of 1, 4 and 12 of those maps: the forward alone, and forward + backward to
    copies of the maps as leaves;
  * autograd's own cost: a ``Function`` that launches nothing and returns ready
    gradients, with 1, 4 and 12 inputs;
  * the twelve maps as the pipelines took them before the groups: one call a map, each
    times its coefficient and summed, and without the coefficients;
  * the twelve maps as views of their heads (NCHW heads viewed NHWC, the flow channels
    sliced), group forward + backward to the heads.

Each item is timed twice, the items in order and then reversed (the host's speed drifts
within a run). No CPU path: without a card it exits non-zero.

Usage: python -m tf_depth_estimation_torch.tools.loss_host_cost
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.ops import _launch
from tf_depth_estimation_torch.ops import smoothness as sm
from tf_depth_estimation_torch.tools.common import require_cuda


def host_us(fn: Callable[[], object], n: int = 200) -> tuple:
    """(enqueue, wall) microseconds a call of ``fn`` over ``n`` calls after 10."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def config4_maps(device, seed: int = 0):
    """(heads, maps, coefs): config 4's depth and flow heads at 4 scales (NCHW, leaves),
    its twelve smoothness maps (views of the heads, as the step passes them) and their
    coefficients, smooth_weight / 2**s."""
    rng = np.random.RandomState(seed)
    weight = LossWeights.optflow_combine().smooth_weight
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).requires_grad_(True)
    heads, maps, coefs = [], [], []
    for s in range(4):
        h, w = 224 >> s, 480 >> s
        depth, flow = t(rng.uniform(0, 4, (10, 1, h, w))), t(rng.randn(10, 2, h, w))
        heads += [depth, flow]
        maps += [depth.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1)[..., 0:1],
                 flow.permute(0, 2, 3, 1)[..., 1:2]]
        coefs += [weight / 2**s] * 3
    return heads, maps, coefs


def _nop(n_inputs: int, grads: List[torch.Tensor], device):
    """A ``Function`` of ``n_inputs`` inputs that launches nothing and returns ``grads``."""

    class Nop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *inputs):
            return torch.empty((), device=device)

        @staticmethod
        def backward(ctx, ct):
            return tuple(grads[:n_inputs])

    return Nop


def items(device) -> Dict[str, Callable[[], object]]:
    """label -> the call it times."""
    heads, maps, coefs = config4_maps(device)
    copies = [m.detach().clone().requires_grad_(True) for m in maps]
    desc, tiles, layout, pixels = sm._plan(copies, coefs)
    lib = sm._lib()
    buf = torch.empty((1 + len(maps) + 4 * tiles,), device=device)
    grad = torch.empty((pixels,), device=device)
    ct = torch.ones((), device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ticket = _launch._ticket(device, stream)
    ready = [torch.empty_like(c) for c in copies]
    out = {
        "checks of 12 maps": lambda: sm._check_group(copies, coefs),
        "descriptors of 12 maps": lambda: sm._plan(copies, coefs),
        "stream query": lambda: torch.cuda.current_stream(device).cuda_stream,
        "forward launch (ctypes)": lambda: lib.smoothness_group_forward(
            desc, buf.data_ptr() + 4 * (1 + len(maps)), buf.data_ptr(), ticket, stream),
        "backward launch (ctypes)": lambda: lib.smoothness_group_backward(
            desc, ct.data_ptr(), None, 0, grad.data_ptr(), stream),
        "12 gradient views": lambda: [torch.as_strided(grad, *at) for at in layout],
    }
    for k in (1, 4, 12):
        c, w = copies[:k], coefs[:k]
        out[f"group of {k}, forward"] = \
            lambda c=c, w=w: _no_grad(lambda: sm.smoothness_fused_group(c, w))
        out[f"group of {k}, forward + backward"] = \
            lambda c=c, w=w: torch.autograd.grad(sm.smoothness_fused_group(c, w)[0], c)
        nop = _nop(k, ready, device)
        out[f"autograd alone, {k} inputs, forward + backward"] = \
            lambda c=c, nop=nop: torch.autograd.grad(nop.apply(*c), c)
    out["12 single-map calls times their coefficients, forward + backward"] = \
        lambda: torch.autograd.grad(
            sum(w * sm.smoothness_fused(m) for w, m in zip(coefs, copies)), copies)
    out["12 single-map calls, forward + backward"] = \
        lambda: torch.autograd.grad(sum(sm.smoothness_fused(m) for m in copies), copies)
    out["group of 12 views of the heads, forward + backward"] = \
        lambda: torch.autograd.grad(sm.smoothness_fused_group(maps, coefs)[0], heads)
    return out


def _no_grad(fn):
    with torch.no_grad():
        return fn()


def main() -> Dict[str, List[tuple]]:
    card = require_cuda()
    device = torch.device("cuda", torch.cuda.current_device())
    calls = items(device)
    times: Dict[str, List[tuple]] = {label: [] for label in calls}
    for label in [*calls, *reversed(calls)]:
        times[label].append(host_us(calls[label]))
    for label, turns in times.items():
        print(f"host {label}: " + "; ".join(f"{e:.1f} us enqueue, {w:.1f} us wall"
                                             for e, w in turns) + f" [{card}]")
    return times


if __name__ == "__main__":
    main()
