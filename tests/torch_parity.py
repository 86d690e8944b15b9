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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_odometry import render_seq, small_cfg  # noqa: F401 (re-exported)

from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
from dynamic_direct_lidar_odometry_tpu_torch import config as port_config
from dynamic_direct_lidar_odometry_tpu_torch import pipeline as port_pipeline
from dynamic_direct_lidar_odometry_tpu_torch.core import device as port_device


def port_cfg(cfg):
    """The port's config equal field by field to a JAX package config
    (both packages define the same dataclasses under the same names)."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(port_config, type(cfg).__name__)
        return cls(**{f.name: port_cfg(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})
    return cfg


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


def _corners(state):
    """(S, 4, 2) rectangle corners of [cx, cy, cz, sin(yaw/2), l, w, h]:
    independent of the PCA frame's sign."""
    yaw = 2.0 * np.arcsin(np.clip(state[:, 3], -1.0, 1.0))
    u = np.stack([np.cos(yaw), np.sin(yaw)], -1)
    v = np.stack([-u[:, 1], u[:, 0]], -1)
    out = []
    for a, b in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
        out.append(state[:, :2] + a * 0.5 * state[:, 4:5] * u + b * 0.5 * state[:, 5:6] * v)
    return np.stack(out, 1)


def assert_boxes_match(p_state, j_state, xy_tol=1e-2):
    cp, cj = _corners(p_state), _corners(j_state)
    d = np.linalg.norm(cp[:, :, None] - cj[:, None], axis=-1)  # (S, 4, 4)
    assert max(d.min(axis=2).max(), d.min(axis=1).max()) < xy_tol
    np.testing.assert_allclose(p_state[:, [2, 6]], j_state[:, [2, 6]], atol=1e-4)


# The runs start from a pose yawed by 0.4 rad, so the town's walls are not
# axis-aligned in the pipeline's world frame. An axis-aligned thin wall's
# PCA frame is f32 rounding noise (its raw-moment cross term cancels to
# noise, see tests/test_torch_detection.py) and its sign flips between
# implementations; the tracker's IoU reads that frame, so such scenes
# would compare rounding, not tracking.
T0 = np.array(
    [[np.cos(0.4), -np.sin(0.4), 0, 0], [np.sin(0.4), np.cos(0.4), 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    np.float32,
)


def run_jax_ddlo(cfg, scans, state=None, start=1):
    """The JAX pipeline from T0 (or ``state``) over ``scans[start:]``:
    (states, outputs) per scan."""
    if state is None:
        state = jpipe.init_state(
            cfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]), 0.0, jnp.asarray(T0)
        )
    states, outs = [], []
    for i in range(start, len(scans)):
        state, out = jpipe.step(cfg, state, jnp.asarray(scans[i][0]), jnp.asarray(scans[i][1]),
                                jnp.float32(0.1 * i))
        states.append(state)
        outs.append(out)
    return states, outs


def run_port_ddlo(cfg, scans, state=None, start=1):
    """The port's pipeline on the CPU, as :func:`run_jax_ddlo`."""
    pcfg = port_cfg(cfg)
    if state is None:
        state = port_pipeline.init_state(pcfg, scans[0][0], scans[0][1], 0.0, T0, device="cpu")
    states, outs = [], []
    for i in range(start, len(scans)):
        state, out = port_pipeline.step(pcfg, state, scans[i][0], scans[i][1], 0.1 * i)
        states.append(state)
        outs.append(out)
    return states, outs


def assert_ddlo_parity(j_out, p_out, j_state, p_state):
    """One scan's bars (tests/test_torch_pipeline_dynamic.py)."""
    jT, pT = np.asarray(j_out.odom.T), n(p_out.odom.T)
    assert np.abs(pT[:3, 3] - jT[:3, 3]).max() < 1e-3
    assert rot_err(pT[:3, :3], jT[:3, :3]) < 1e-3
    assert bool(p_out.keyframe_added) == bool(j_out.keyframe_added)
    np.testing.assert_array_equal(n(p_out.detections.objects.valid),
                                  np.asarray(j_out.detections.objects.valid))
    np.testing.assert_allclose(n(p_out.detections.objects.state),
                               np.asarray(j_out.detections.objects.state), atol=1e-3)
    np.testing.assert_array_equal(n(p_state.tracks.active), np.asarray(j_state.tracks.active))
    np.testing.assert_array_equal(n(p_state.tracks.status), np.asarray(j_state.tracks.status))
