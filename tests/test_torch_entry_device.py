"""The port's entry points run on the card unless the caller asks for the
CPU. Without a card, the default raises: nothing quietly carries on on
the host. With one, the default state lives on it. (The parity tests
pass ``device="cpu"``.)"""

import numpy as np
import pytest
import torch

from torch_parity import plain_cfg, port_cfg

from dynamic_direct_lidar_odometry_tpu_torch import pipeline, runner
from dynamic_direct_lidar_odometry_tpu_torch.core import device
from dynamic_direct_lidar_odometry_tpu_torch.io.dataset import ScanSequence
from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes, odometry
from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker


def _scan(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n = cfg.detection.rows * cfg.detection.columns
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    return pts, np.ones(n, bool)


def _replay(cfg, pts, m):
    seq = ScanSequence(points=np.stack([pts, pts]), mask=np.stack([m, m]), stamps=np.array([0.0, 0.1]),
                       H=cfg.detection.rows, W=cfg.detection.columns)
    return runner.replay(cfg, seq, map_capacity=1000).final_state.odom.T


ENTRY_POINTS = {
    "pipeline.init_state": lambda cfg, pts, m: pipeline.init_state(cfg, pts, m).odom.T,
    "odometry.init_state": lambda cfg, pts, m: odometry.init_state(cfg, pts, m).T,
    "tracker.empty_state": lambda cfg, pts, m: tracker.empty_state(4).active,
    "keyframes.empty_store": lambda cfg, pts, m: keyframes.empty_store(2, 8).points,
    "mapper.empty_map": lambda cfg, pts, m: mapper.empty_map(4).points,
    "runner.replay": _replay,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(entry):
    cfg = port_cfg(plain_cfg())
    pts, m = _scan(cfg)
    if torch.cuda.is_available():
        assert ENTRY_POINTS[entry](cfg, pts, m).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[entry](cfg, pts, m)


def test_cpu_on_request_and_resolve_rules():
    cfg = port_cfg(plain_cfg())
    pts, m = _scan(cfg, seed=1)
    st = pipeline.init_state(cfg, pts, m, device="cpu")
    assert st.odom.T.device.type == "cpu" and st.prev_stamp.device.type == "cpu"
    assert device.resolve("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for arg in ("cuda", "cuda:0", torch.device("cuda")):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                device.resolve(arg)
