"""Filesystem checkpoints of numpy trees: one .npz of leaves + a JSON
manifest, the format of ``repro/checkpoint/ckpt.py``.

Leaves are keyed by their path as JAX's ``tree_util.keystr`` spells
it, joined with "/" (``['layers']/[0]/['w1']/['w']``): dict keys in
sorted order, tuple and list items by index, None holding no leaf. So a
tree in the JAX package's layout (``bridge.gates_to_jax``) saved here
is restored by ``repro.checkpoint.restore``, and the reverse.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (f"[{i}]",))]
    return [("/".join(prefix), np.asarray(tree))]


def _unflatten(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save(path: str, tree, step: int | None = None) -> None:
    """Write ``path``.npz and ``path``.json; the .npz lands by rename."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    leaves = dict(_flatten_with_paths(tree))
    manifest = {"keys": sorted(leaves.keys()), "step": step}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **leaves)
    os.replace(tmp, path + ".npz")
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def restore(path: str, like):
    """Restore into the structure of ``like`` (a numpy tree; shapes
    validated, dtypes taken from ``like``)."""
    data = np.load(path + ".npz")
    out = []
    for key, leaf in _flatten_with_paths(like):
        arr = data[key]
        if arr.shape != leaf.shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {leaf.shape}")
        out.append(arr.astype(leaf.dtype))
    return _unflatten(like, iter(out))


def latest_step(path: str) -> int | None:
    try:
        with open(path + ".json") as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
