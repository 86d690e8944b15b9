"""State bridge between the JAX package and the port.

The system has no weights; its state (pose, previous scan, keyframe
store, hull cache, tracker) is what a run carries. These two functions
move it across field by field, so both implementations can start from
the same mid-sequence state:

    jax_np = jax.tree.map(np.asarray, jax_state)     # JAX side
    port_state = state_from_numpy(jax_np, "cuda")
    back = state_to_numpy(port_state)                # numpy leaves

Containers are matched by class name (the states ``DDLOState``,
``OdomState``, ``KeyframeStore``, ``TrackerState``, ``MapState``, and the outputs
``DetectionResult``, ``Objects``, ``TrackerOutputs``); leaves keep their
dtype and shape. ``state_to_numpy`` takes any of them, so tests compare
outputs field by field. A vmapped JAX state (every leaf with a leading
batch axis) crosses the same way into the port's stacked state
(``parallel.sharding.batched_init_state``, ``replay_batch``'s final
states) and back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.core.tree import is_namedtuple
from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper
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
        mapper.MapState,
        detection.DetectionResult,
        bbox.Objects,
        tracker.TrackerOutputs,
    )
}


def state_from_numpy(tree: Any, device) -> Any:
    """A JAX state container with numpy leaves -> the port's container
    with tensors on ``device``."""
    if is_namedtuple(tree):
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
    if is_namedtuple(state):
        return type(state)(*(state_to_numpy(v) for v in state))
    return state.detach().cpu().numpy()
