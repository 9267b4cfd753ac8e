"""What the loss kernels' wrappers (``ops/smoothness.py``, ``ops/sig_l2.py``) share: the
call of a C launch function on the current stream of a tensor's card, the raise on the
``cudaError_t`` it returns, the ticket of a grouped reduction, and the sum of a group
whose maps take the kernel or the plain term."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

# (device index, stream) -> a zeroed unsigned int on that device (see ``_ticket``)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int) -> int:
    """The address of the unsigned int that a grouped reduction's blocks count themselves
    on to find the last one. It is allocated zeroed once for each (device, stream), and
    the kernel that takes it resets it to 0 before it exits: launches on one stream run
    one after another, so it is 0 at every launch; two streams hold two tickets, so they
    cannot race. Kernels of both loss libraries share a stream's ticket for that reason."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t.data_ptr()


def run(c_fn, device: torch.device, *args, ticket: bool = False) -> None:
    """``c_fn(*args[, ticket], stream)`` on the current stream of ``device``; with
    ``ticket`` the stream's ticket goes before the stream. Enters ``device``'s context only
    when another card is current. Raises when ``c_fn`` returns a ``cudaError_t`` other
    than 0."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if ticket:
        args = (*args, _ticket(device, stream))
    if device.index == torch.cuda.current_device():
        err = c_fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = c_fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{c_fn.__name__} failed: cudaError_t {err}")


def group_terms(coefs: Sequence[float], eligible: List[bool],
                kernel: Callable[[List[int]], Tuple[torch.Tensor, torch.Tensor]],
                plain: Callable[[int], torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, per_map) of a group: ``kernel(ks)`` gives (the coefficient-weighted sum,
    the terms) of the eligible maps ``ks`` in one launch each way, ``plain(k)`` the plain
    term of map k. ``total`` adds the kernel's sum first, then ``coefs[k] * plain(k)`` in
    the order of the maps."""
    ks = [k for k, e in enumerate(eligible) if e]
    total, per_map = None, [None] * len(coefs)
    if ks:
        total, terms = kernel(ks)
        for k, v in zip(ks, terms):
            per_map[k] = v
    for k, v in enumerate(per_map):
        if v is None:
            per_map[k] = plain(k)
            term = coefs[k] * per_map[k]
            total = term if total is None else total + term
    return total, torch.stack(per_map)
