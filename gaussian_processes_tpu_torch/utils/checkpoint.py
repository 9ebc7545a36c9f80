"""Sampler checkpoint / resume.

Counterpart of ``gaussian_processes_tpu/utils/checkpoint.py``, in its file
layout: ``np.savez`` of the flattened leaves ``leaf_0 .. leaf_{n-1}`` and a
JSON ``__manifest__`` (leaf count, which leaves are random-number states),
written to ``path + ".tmp"`` and moved into place with ``os.replace``, so a
preempted run never leaves a torn checkpoint.

A tree is any nesting of dicts (sorted keys), lists, tuples, NamedTuples and
dataclasses (the samplers' ``SamplerState``, ``CheesState``,
``DualAveragingState``, ``WelfordState``, the sharded states) whose leaves
are tensors, Python scalars or ``torch.Generator``\\ s; ``None`` holds no
leaf.  A generator is stored as its ``get_state()`` bytes and flagged in the
manifest (the counterpart of the JAX package's typed PRNG keys), so a
restored state draws the same numbers.  ``load_pytree(path, like)`` takes
the structure, dtypes and devices from ``like``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _children(tree):
    """(kind, children) of a container, or None for a leaf."""
    if tree is None:
        return "none", []
    if isinstance(tree, dict):
        return "dict", [tree[k] for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return "namedtuple", list(tree)
    if isinstance(tree, (list, tuple)):
        return "seq", list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return "dataclass", [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return None


def _flatten(tree, out: list) -> None:
    node = _children(tree)
    if node is None:
        out.append(tree)
        return
    for child in node[1]:
        _flatten(child, out)


def _unflatten(like, leaves):
    node = _children(like)
    if node is None:
        return next(leaves)
    kind, children = node
    values = [_unflatten(c, leaves) for c in children]
    if kind == "none":
        return None
    if kind == "dict":
        return dict(zip(sorted(like), values))
    if kind == "namedtuple":
        return type(like)(*values)
    if kind == "seq":
        return type(like)(values)
    return type(like)(**{f.name: v for f, v in zip(dataclasses.fields(like), values)})


def _to_raw(leaf):
    """(numpy array, is a generator state)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy(), True
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy(), False
    return np.asarray(leaf), False


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors, scalars and generators to ``path`` (.npz)."""
    leaves: list = []
    _flatten(tree, leaves)
    arrays = {}
    is_key = []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], flag = _to_raw(leaf)
        is_key.append(flag)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"n": len(leaves), "is_key": is_key}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: no torn checkpoints on preemption


def _restore(arr: np.ndarray, raw_is_key: bool, like):
    if raw_is_key:
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(np.array(arr, dtype=np.uint8)))
        return gen
    if torch.is_tensor(like):
        return torch.as_tensor(np.array(arr), device=like.device).to(like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return arr


def load_pytree(path: str, like: Any) -> Any:
    """Load a tree saved by ``save_pytree``; ``like`` supplies the structure,
    and each leaf's dtype and device (a generator is rebuilt on ``like``'s
    generator's device).  Raises ``ValueError`` on a leaf-count mismatch."""
    leaves_like: list = []
    _flatten(like, leaves_like)
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        n = manifest["n"]
        if n != len(leaves_like):
            raise ValueError(f"checkpoint has {n} leaves, template has {len(leaves_like)}")
        leaves = [_restore(data[f"leaf_{i}"], flag, leaf_like)
                  for i, (flag, leaf_like) in enumerate(zip(manifest["is_key"], leaves_like))]
    return _unflatten(like, iter(leaves))
