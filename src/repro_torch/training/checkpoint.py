"""Checkpointing, the port of the reference ``repro/training/checkpoint.py``:
a tree of tensors flattened to an ``.npz`` whose keys are the ``|``-joined
paths (dict keys, sequence indices), restored onto an existing structure
with shapes checked.

The layout is the reference's, so each package reads the other's file. A
bfloat16 leaf is written as the reference's numpy writes it (raw 2-byte
``|V2`` elements: numpy has no bfloat16) and read back into a bfloat16
tensor from those bytes.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

_SEP = "|"


def _paths(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _paths(v, prefix + ("." + name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save(tree: Any, path: str) -> None:
    flat = {key: _to_numpy(leaf) for key, leaf in _paths(tree)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:        # file object: numpy won't append .npz
        np.savez(f, **flat)
    os.replace(tmp, path)


def _leaf_from(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def restore(template: Any, path: str) -> Any:
    """A tree shaped as ``template`` (a tree of tensors) holding the file's
    leaves in each template leaf's dtype and device."""
    z = np.load(path)
    leaves = {}
    for key, leaf in _paths(template):
        if key not in z:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = z[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        leaves[key] = _leaf_from(arr, leaf)

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(build(v, prefix + ("." + n,))
                                for n, v in zip(tree._fields, tree)))
        if isinstance(tree, (tuple, list)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        return leaves[_SEP.join(prefix)]
    return build(template)
