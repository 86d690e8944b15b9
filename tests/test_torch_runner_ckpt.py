"""Checkpoints of the port's replay: a port checkpoint resumes bit-equal
to the uninterrupted run, and a checkpoint the JAX package wrote
restores into the port (same leaf order, shapes and dtypes) and the
port's next step matches JAX's."""

import os

import numpy as np
import pytest
import torch

from torch_parity import port_cfg
from torch_replay_parity import _seq, lean_cfg

from dynamic_direct_lidar_odometry_tpu import runner as jrunner
from dynamic_direct_lidar_odometry_tpu_torch import interop, runner
from dynamic_direct_lidar_odometry_tpu_torch.utils import checkpoint

N_SCANS = 4
EVERY = 2  # one checkpoint, after scan 2; scan 3 is resumed
CKPT = f"ckpt_{EVERY:06d}.npz"


@pytest.fixture(scope="module")
def scene():
    seq = _seq(n=N_SCANS)
    return seq, lean_cfg(seq)


@pytest.fixture(scope="module")
def port_full(scene, tmp_path_factory):
    seq, cfg = scene
    out = str(tmp_path_factory.mktemp("port"))
    return runner.replay(port_cfg(cfg), seq, out_dir=out, checkpoint_every=EVERY,
                         map_capacity=20_000, device="cpu"), out


@pytest.fixture(scope="module")
def jax_full(scene, tmp_path_factory):
    seq, cfg = scene
    out = str(tmp_path_factory.mktemp("jax"))
    return jrunner.replay(cfg, seq, out_dir=out, checkpoint_every=EVERY, map_capacity=20_000,
                          hulls="device"), out


def _leaves(*states):
    """The numpy leaves of port states, in checkpoint order."""
    return [x for st in states for x in checkpoint._leaves(interop.state_to_numpy(st))]


def test_port_checkpoint_resumes_bit_equal(scene, port_full):
    seq, cfg = scene
    full, out = port_full
    resumed = runner.replay(port_cfg(cfg), seq, resume_from=os.path.join(out, CKPT),
                            map_capacity=20_000, device="cpu")
    assert len(resumed.poses) == N_SCANS - EVERY - 1
    np.testing.assert_array_equal(resumed.poses, full.poses[-len(resumed.poses):])
    np.testing.assert_array_equal(resumed.quats, full.quats[-len(resumed.quats):])
    assert resumed.map_points == full.map_points
    for a, b in zip(_leaves(resumed.final_state, resumed.map_state),
                    _leaves(full.final_state, full.map_state)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_layouts_match(port_full, jax_full):
    """The same keys, shapes and dtypes, leaf by leaf."""
    p = np.load(os.path.join(port_full[1], CKPT))
    j = np.load(os.path.join(jax_full[1], CKPT))
    assert sorted(p.files) == sorted(j.files)
    for k in j.files:
        assert (p[k].shape, p[k].dtype) == (j[k].shape, j[k].dtype), k
    assert bytes(p["__meta__"]) == bytes(j["__meta__"])


def test_jax_checkpoint_restores_into_port(scene, jax_full):
    seq, cfg = scene
    jres, out = jax_full
    path = os.path.join(out, CKPT)
    like = (runner.pipeline.init_state(port_cfg(cfg), seq.points[0], seq.mask[0], device="cpu"),
            runner.mapper.empty_map(20_000, device="cpu"))
    (state, map_state), meta = checkpoint.restore(path, like)
    assert meta == {"next_scan": EVERY + 1}
    data = np.load(path)
    for i, leaf in enumerate(_leaves(state, map_state)):
        np.testing.assert_array_equal(leaf, data[f"leaf_{i}"])
    assert state.odom.T.dtype == torch.float32 and state.odom.store.valid.dtype == torch.bool

    # the port continues from the JAX state: its next step matches JAX's
    resumed = runner.replay(port_cfg(cfg), seq, resume_from=path, map_capacity=20_000, device="cpu")
    np.testing.assert_allclose(resumed.poses, jres.poses[-len(resumed.poses):], atol=1e-4)
    assert resumed.num_keyframes == jres.num_keyframes


def test_restore_rejects_other_capacities(scene, port_full):
    seq, cfg = scene
    like = (runner.pipeline.init_state(port_cfg(cfg), seq.points[0], seq.mask[0], device="cpu"),
            runner.mapper.empty_map(10_000, device="cpu"))
    with pytest.raises(ValueError, match="capacities"):
        checkpoint.restore(os.path.join(port_full[1], CKPT), like)
