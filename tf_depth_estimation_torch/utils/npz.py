"""Flat ``.npz`` weight files: the serving format shared with the JAX package.

Keys are '/'-joined paths of the JAX variables tree (``params/encoder/cnv1/Conv_0/kernel``,
``batch_stats/.../BatchNorm_0/{mean,var}``), values float32 numpy arrays. ``__meta_<name>``
keys hold string metadata; ``__collections`` names the top-level collections, so that an
empty one (a BN-free model's ``batch_stats``) comes back as ``{}``. The layout is kept
byte-for-byte with ``tf_depth_estimation_tpu/train/checkpoint.py`` so that either package
reads what the other writes; this module is the port's own copy and imports neither JAX nor
that package.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    else:
        a = np.asarray(tree)
        if not (np.issubdtype(a.dtype, np.floating)
                or a.dtype.name in ("bfloat16", "float16")):
            raise TypeError(
                f"serving variable {prefix.rstrip(_SEP)!r} has non-float dtype "
                f"{a.dtype} — .npz weights store f32 floats only")
        out[prefix.rstrip(_SEP)] = a.astype(np.float32)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_variables_npz(path: str, variables: Dict[str, Any], **meta: str) -> None:
    """Write serving variables (``{'params': ..., 'batch_stats': ...}``) as one .npz,
    stored, not deflated: deflate barely shrinks float32 weights and costs seconds a save
    at DepthPoseNet's and DispNet's ~30 M parameters (``np.load`` reads either).

    ``meta`` keys are stored under ``__meta_<name>`` and returned by
    :func:`load_variables_npz`.
    """
    flat = _flatten(dict(variables))
    for name, value in meta.items():
        flat[f"__meta_{name}"] = np.asarray(str(value))
    flat["__collections"] = np.asarray(",".join(sorted(variables)))
    np.savez(path, **flat)


def load_variables_npz(path: str) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Inverse of :func:`save_variables_npz` -> ``(variables, meta)``."""
    with np.load(path) as data:
        meta = {k[len("__meta_"):]: str(data[k]) for k in data.files
                if k.startswith("__meta_")}
        collections = ([c for c in str(data["__collections"]).split(",") if c]
                       if "__collections" in data.files else [])
        flat = {k: data[k] for k in data.files
                if not (k.startswith("__meta_") or k == "__collections")}
    tree = _unflatten(flat)
    for name in collections:
        tree.setdefault(name, {})
    return tree, meta
