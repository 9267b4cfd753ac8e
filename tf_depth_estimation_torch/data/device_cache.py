"""Device-resident dataset cache: upload a small corpus to device memory once, gather each
batch there.

The port of ``tf_depth_estimation_tpu/data/device_cache.py``. When a whole corpus fits on
the card (synthetic scenes, distillation frame sets, overfit experiments), the input
pipeline is no pipeline: the arrays cross to the device once, and each step gathers its
batch on the device from a host-sent index vector, so a step moves O(batch) indices to the
device and not O(batch) images. uint8 arrays stay uint8 on the device (a quarter of the
float32 bytes) and become float32 at the gather. Mirror-x and rot180 (the DeMoN reader's
pair, ``data/demon.py``) are applied on the device from host-sent per-sample bits. ::

    cache = DeviceCache({"tgt_image": frames_u8, "label": depths},
                        float_keys=("tgt_image",), aug_keys=("tgt_image", "label"))
    for idx, flip, rot in cache.index_stream(batch_size=16, seed=0, augment=True):
        state, metrics = step(state, cache.gather(idx, flip=flip, rot=rot))
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _on(x, device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x).to(device, non_blocking=True)


def gather_batch(data: Dict[str, torch.Tensor], idx, *, float_keys: Sequence[str] = (),
                 aug_keys: Sequence[str] = (), flip=None, rot=None) -> Dict[str, torch.Tensor]:
    """Gather rows ``idx`` of each array, cast integer ``float_keys`` to float32, and
    mirror-x (``flip``) and rotate by 180 degrees (``rot``) each sample of the spatial
    ``aug_keys`` ([B, H, W, C]) where its bit is set. ``idx``, ``flip`` and ``rot`` may be
    host arrays; they are moved to the data's device. Image and label take the same
    transform, which is why the transformed arrays are named by key."""
    device = next(iter(data.values())).device
    idx = _on(idx, device).long()
    flip, rot = _on(flip, device), _on(rot, device)
    batch = {}
    for k, v in data.items():
        b = v[idx]
        if k in float_keys and not b.is_floating_point():
            b = b.float()
        if k in aug_keys:
            if flip is not None:
                b = torch.where(flip[:, None, None, None], b.flip(2), b)
            if rot is not None:
                b = torch.where(rot[:, None, None, None], b.flip(1, 2), b)
        batch[k] = b
    return batch


class DeviceCache:
    """The corpus on ``device`` and the host's stream of indices and augmentation bits."""

    def __init__(self, arrays: Dict[str, np.ndarray], float_keys: Sequence[str] = (),
                 aug_keys: Sequence[str] = (), device: Union[str, torch.device] = "cuda"):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged corpus: {sizes}")
        self.num_samples = next(iter(sizes.values()))
        self.device = torch.device(device)
        self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                     for k, v in arrays.items()}
        self.float_keys = tuple(float_keys)
        self.aug_keys = tuple(aug_keys)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def gather(self, idx, flip=None, rot=None) -> Dict[str, torch.Tensor]:
        """``gather_batch`` over this cache's arrays and key sets."""
        return gather_batch(self.data, idx, float_keys=self.float_keys,
                            aug_keys=self.aug_keys, flip=flip, rot=rot)

    def index_stream(self, batch_size: int, seed: int = 0, augment: bool = False,
                     num_steps: Optional[int] = None
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Host-side ``(idx, flip, rot)``: uniform sampling with replacement, and with
        ``augment`` p = 0.5 mirror and rot180, drawn in the JAX package's order."""
        rng = np.random.RandomState(seed)
        step = 0
        while num_steps is None or step < num_steps:
            idx = rng.randint(0, self.num_samples, size=batch_size).astype(np.int32)
            if augment:
                flip = rng.rand(batch_size) < 0.5
                rot = rng.rand(batch_size) < 0.5
            else:
                flip = np.zeros(batch_size, bool)
                rot = np.zeros(batch_size, bool)
            yield idx, flip, rot
            step += 1
