"""The trees the utilities walk: dicts, lists and tuples of tensors, and
dataclasses and NamedTuples (the port's states) holding them.

Paths use the JAX package's `keystr` form: `['key']` for a dict entry,
`[i]` for a list or tuple element, `.field` for a dataclass or NamedTuple
field. Dict entries come in sorted key order, as JAX flattens them."""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch


def is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def children(node: Any) -> list[tuple[str, Any]] | None:
    """(path step, child) pairs of a container node; None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    if is_namedtuple(node):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def tensors_with_path(tree: Any, path: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """Every tensor leaf with its path, depth first; other leaves (numbers,
    strings, None, generators) are skipped."""
    kids = children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            yield path, tree
        return
    for step, child in kids:
        yield from tensors_with_path(child, path + step)


def tensors(tree: Any) -> list[torch.Tensor]:
    return [t for _, t in tensors_with_path(tree)]
