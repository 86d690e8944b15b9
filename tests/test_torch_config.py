"""The port's own copies of the JAX package's jax-free modules: ``config``
equal field by field (through ``dataclasses.asdict``), and ``io.synthetic``
/ ``io.dataset`` rendering bit-identical scans (by ``sequence_sha256``)."""

import dataclasses

import numpy as np
import pytest

from torch_parity import port_cfg, small_cfg

from dynamic_direct_lidar_odometry_tpu import config as jconfig
from dynamic_direct_lidar_odometry_tpu.io import dataset as jdataset
from dynamic_direct_lidar_odometry_tpu.io import synthetic as jsynthetic
from dynamic_direct_lidar_odometry_tpu_torch import config
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset, synthetic
from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

# a reference-format YAML dict written out by hand: every namespace, some
# keys left to their defaults, the square-image residual-grid rule
REFERENCE_DICT = {
    "printStatus": True,
    "dynamicDetection": False,
    "odomFrame": "map",
    "odomNode": {
        "preprocessing": {
            "downsampling": {"use": True, "row": 2, "col": 4},
            "cropBoxFilter": {"use": True, "size": 0.5},
            "voxelFilter": {"scan": {"use": True, "res": 0.2}},
        },
        "keyframe": {"threshD": 2.0, "threshR": 30.0},
        "submap": {"keyframe": {"knn": 5, "kcv": 6, "kcc": 7}},
        "gicp": {
            "minNumPoints": 50,
            "s2s": {"kCorrespondences": 12, "maxIterations": 16},
            "s2m": {"maxCorrespondenceDistance": 1.5, "ransac": {"iterations": 3}},
        },
        "detection": {"rows": 256, "columns": 256, "theta": 0.2, "minPointNum": 9},
        "tracking": {"maxNoHits": 7, "maxObjVelocity": 4.0},
        "evaluation": {"evaluate": True, "dir": "/data/eval"},
    },
    "mapNode": {"leafSize": 0.3, "filterMargin": 0.1},
}


@pytest.mark.parametrize(
    "make",
    [
        lambda c: c.doals_config(),
        lambda c: c.bench_config(),
        lambda c: c.bench_config(dynamic_detection=False),
        lambda c: c.kantplatz_config(),
        lambda c: c.config_from_dict(REFERENCE_DICT),
        lambda c: c.config_from_dict({}),
        lambda c: c.capacity_for_scan(64, 1024),
    ],
    ids=["doals", "bench", "bench_plain", "kantplatz", "reference_dict", "empty_dict", "capacity"],
)
def test_presets_equal_jax(make):
    ours, theirs = make(config), make(jconfig)
    assert type(ours).__module__ == config.__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_port_cfg_helper_builds_the_port_class():
    jc = small_cfg()
    pc = port_cfg(jc)
    assert isinstance(pc, config.DDLOConfig) and isinstance(pc.detection, config.DetectionConfig)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


def test_synthetic_sequence_bit_identical():
    ours = dataset.synthetic_sequence(n_scans=3, H=16, W=128, seed=5)
    theirs = jdataset.synthetic_sequence(n_scans=3, H=16, W=128, seed=5)
    assert sequence.sequence_sha256(ours, 3) == sequence.sequence_sha256(theirs, 3)
    assert ours.H == theirs.H and ours.W == theirs.W


def test_render_scan_and_town_bit_identical():
    wa, wb = synthetic.World.town(seed=7, n_static=10), jsynthetic.World.town(seed=7, n_static=10)
    assert len(wa.boxes) == len(wb.boxes)
    for a, b in zip(wa.boxes, wb.boxes):
        np.testing.assert_array_equal(a.center, b.center)
        np.testing.assert_array_equal(a.size, b.size)
    mover = [synthetic.Box(np.array([4.0, -2.0, 0.9]), np.array([0.8, 0.8, 1.8]), np.array([1.0, 0.3, 0.0]))]
    T = synthetic.spiral_trajectory(5)[3]
    pa, ma = synthetic.render_scan(wa, T, H=16, W=128, t=0.3, extra_boxes=mover,
                                   rng=np.random.default_rng(1))
    pb, mb = jsynthetic.render_scan(wb, T, H=16, W=128, t=0.3, extra_boxes=mover,
                                    rng=np.random.default_rng(1))
    np.testing.assert_array_equal(np.nan_to_num(pa), np.nan_to_num(pb))
    np.testing.assert_array_equal(ma, mb)
    for ta, tb in zip(synthetic.circular_trajectory(4), jsynthetic.circular_trajectory(4)):
        np.testing.assert_array_equal(ta, tb)
