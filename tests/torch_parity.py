"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX
function (on the CPU) and its port. Two ways into the accelerator
branches, both without a GPU:

- JAX: ``jax_tpu_paths`` patches ``jax.default_backend`` to "tpu" (as
  tests/test_nn_pallas.py does) and runs Pallas in interpret mode. jit
  caches traces by argument, not by the patched backend, so a patched
  call must use a config or a shape that no other test in the process
  uses (:func:`tpu_cfg` differs from :func:`plain_cfg` in capacities).
- Port: ``port_accelerator_paths`` forces ``device.on_accelerator`` to
  True on CPU tensors; the kernels' plain versions then run.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_odometry import render_seq, small_cfg  # noqa: F401 (re-exported)

from dynamic_direct_lidar_odometry_tpu_torch.core import device as port_device


def plain_cfg():
    """tests/test_odometry.py's small_cfg with dynamic detection off."""
    return dataclasses.replace(small_cfg(), dynamic_detection=False)


def tpu_cfg():
    """Like :func:`plain_cfg` but with capacities no other test uses, so
    the patched-backend JAX traces cannot hit (or poison) a cached CPU
    trace of the same shapes."""
    cfg = plain_cfg()
    cap = dataclasses.replace(
        cfg.capacity,
        max_points=4000, max_keyframe_points=4000, max_submap_points=16000,
    )
    return dataclasses.replace(cfg, capacity=cap)


@contextlib.contextmanager
def jax_tpu_paths():
    from jax.experimental.pallas import tpu as pltpu

    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(jax, "default_backend", lambda: "tpu")
        yield


@contextlib.contextmanager
def port_accelerator_paths():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_device, "on_accelerator", lambda t: True)
        yield


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (copy)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rot_err(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Rotation difference (rad), ||Ra - Rb||_F / sqrt(2): the angle of
    Ra^T Rb to first order, and well conditioned at 0 (the trace/arccos
    form is not, on f32 matrices)."""
    d = Ra.astype(np.float64) - Rb.astype(np.float64)
    return float(np.linalg.norm(d) / np.sqrt(2.0))
