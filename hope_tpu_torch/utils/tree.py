"""Maps over the port's state trees: nested dicts, lists, tuples,
NamedTuples and dataclasses (``EnvState``, ``Scene``, ``HybridState``) with
tensors at the leaves."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a tree of dicts, lists, tuples,
    NamedTuples and dataclasses; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
