"""Stacking and slicing of state and output containers (``NamedTuple``s of
tensors, possibly nested, with ``None`` fields): the port's counterpart
of the leading axis that ``lax.scan`` and ``jax.vmap`` put on every leaf."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_leaves(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of containers of the same structure."""
    first = trees[0]
    if first is None:
        return None
    if is_namedtuple(first):
        return type(first)(*(map_leaves(fn, *fields) for fields in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(map_leaves(fn, *items) for items in zip(*trees))
    return fn(*trees)


def stack(trees: Sequence[Any]) -> Any:
    """Containers -> one container, every leaf stacked along a new dim 0."""
    return map_leaves(lambda *leaves: torch.stack(leaves), *trees)


def index(tree: Any, i: int) -> Any:
    """Entry ``i`` of a stacked container."""
    return map_leaves(lambda leaf: leaf[i], tree)
