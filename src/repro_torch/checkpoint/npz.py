"""Checkpoints to .npz in the JAX package's own layout (counterpart of
``repro/checkpoint/npz.py``): a checkpoint written by either package
restores in the other.

A tree (nested dicts, lists and tuples of tensors or arrays) is flattened
to ``/``-joined keys as the reference's ``_flatten`` makes them (dict keys
as they are, list and tuple positions as numbers); bf16 is widened to
float32, which npz can hold, and ``restore`` casts each array back to its
template leaf's dtype (and device).  ``save`` writes a temporary file and
renames it, so a reader never sees half a checkpoint.  A model's
parameters go in as ``{"params": bridge.reference_tensors(model)}``, the
reference trainer's ``{"params": params}``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # npz has no bf16; restore() casts back
            leaf = leaf.float()
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def save(path: str, tree, step: Optional[int] = None) -> str:
    """Write ``tree`` to ``path`` (or to ``path/ckpt_%08d.npz`` given a
    step) -> the file's path."""

    if step is not None:
        path = os.path.join(path, f"ckpt_{step:08d}.npz")
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _rebuild(template, data, prefix=""):
    if isinstance(template, dict):
        return {k: _rebuild(v, data, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, data, f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    arr = data[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=template.device, dtype=template.dtype)
    return arr.astype(template.dtype) if hasattr(template, "dtype") else arr


def restore(path: str, template) -> Any:
    """The checkpoint at ``path`` in the structure of ``template``, each leaf
    cast to its template leaf's dtype (a tensor also to its device)."""

    with np.load(path) as data:
        return _rebuild(template, data)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``ckpt_%08d.npz`` of ``ckpt_dir`` with the highest step, or None."""

    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(r"ckpt_(\d+)\.npz$")
    best, best_step = None, -1
    for f in os.listdir(ckpt_dir):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, f), int(m.group(1))
    return best
