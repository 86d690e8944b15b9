"""State bridge between the JAX package and the port.

The system has no weights; its state (pose, previous scan, keyframe
store, hull cache, tracker) is what a run carries. These two functions
move it across field by field, so both implementations can start from
the same mid-sequence state:

    jax_np = jax.tree.map(np.asarray, jax_state)     # JAX side
    port_state = state_from_numpy(jax_np, "cuda")
    back = state_to_numpy(port_state)                # numpy leaves

Containers are matched by class name (the states ``DDLOState``,
``OdomState``, ``KeyframeStore``, ``TrackerState``, and the outputs
``DetectionResult``, ``Objects``, ``TrackerOutputs``); leaves keep their
dtype and shape. ``state_to_numpy`` takes any of them, so tests compare
outputs field by field.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes, odometry
from dynamic_direct_lidar_odometry_tpu_torch.ops import bbox
from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker

_CLASSES = {
    cls.__name__: cls
    for cls in (
        pipeline.DDLOState,
        odometry.OdomState,
        keyframes.KeyframeStore,
        tracker.TrackerState,
        detection.DetectionResult,
        bbox.Objects,
        tracker.TrackerOutputs,
    )
}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_from_numpy(tree: Any, device) -> Any:
    """A JAX state container with numpy leaves -> the port's container
    with tensors on ``device``."""
    if _is_namedtuple(tree):
        name = type(tree).__name__
        if name not in _CLASSES:
            raise TypeError(f"no port container for {name}")
        cls = _CLASSES[name]
        if tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"{name}: fields differ: {cls._fields} vs {tree._fields}")
        return cls(*(state_from_numpy(v, device) for v in tree))
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def state_to_numpy(state: Any) -> Any:
    """The port's state or output container -> the same container with
    numpy leaves."""
    if _is_namedtuple(state):
        return type(state)(*(state_to_numpy(v) for v in state))
    return state.detach().cpu().numpy()
