"""Flat-npz (de)serialization for parameter trees, in the JAX package's format.

A tree is saved as a plain ``.npz`` archive whose keys are ``/``-joined paths,
loadable with nothing but numpy. The format, key order and dtypes are the JAX
package's (``utils/serialization.py``): either package loads what the other
wrote. Tensors are copied to the host first, so a tree of card tensors saves too.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_SEP = "/"


def _host_array(value: Any) -> np.ndarray:
    """``value`` as a numpy array on the host (a torch tensor is detached and copied)."""
    if hasattr(value, "detach") and hasattr(value, "cpu"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict-of-arrays into ``{"a/b/c": ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if _SEP in str(key):
            raise ValueError(f"Tree keys must not contain {_SEP!r}, got {key!r}")
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = _host_array(value)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split(_SEP)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_tree_npz(path: str, tree: Dict[str, Any]) -> str:
    """Write a nested tree to a flat ``.npz`` archive; returns the real path.

    ``np.savez`` appends ``.npz`` to extension-less paths: the path is normalised
    up front so callers always see the file actually written.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **flatten_tree(tree))
    return path


def load_tree_npz(path: str) -> Dict[str, Any]:
    """Load a flat ``.npz`` archive back into a nested tree of numpy arrays."""
    with np.load(path) as data:
        return unflatten_tree({name: data[name] for name in data.files})
