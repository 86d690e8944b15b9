"""Checkpoint / resume of the full DDLO state (counterpart of
``utils/checkpoint.py``).

The reference has no checkpointing (SURVEY.md §5). A checkpoint is a
flat ``.npz`` of the state's leaves, ``leaf_{i}``, plus ``__meta__`` (a
JSON dict as uint8 bytes), in the JAX package's pytree order: the fields
of a NamedTuple (and the items of a tuple or list, a dict's items by
sorted key) depth first, ``None`` skipped. So a checkpoint written by
either package restores into the other.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    got = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(got, copy=True)).to(device=like.device, dtype=like.dtype)
    return got


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state: Any, meta: Optional[dict] = None) -> None:
    """Save a state (NamedTuples / tuples / dicts of tensors) to ``path``
    (.npz)."""
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(_leaves(state))}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def restore(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore a checkpoint into the structure of ``like`` (an example
    state with the right structure and shapes); each tensor leaf lands
    on the device and in the dtype of ``like``'s."""
    data = np.load(path)
    like_leaves = _leaves(like)
    leaves = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"leaf {i}: checkpoint shape {got.shape} != state shape "
                f"{tuple(np.shape(want))}: capacities/config changed since save"
            )
    return _rebuild(like, iter(leaves)), meta
