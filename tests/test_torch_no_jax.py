"""The port and chip_smoke.py run where JAX is not installed (the GPU
host) and never import the JAX package: in a subprocess with ``jax`` and
``dynamic_direct_lidar_odometry_tpu`` (and their submodules) blocked,
import them and run one tiny full-DDLO step on the CPU through
chip_smoke's own helper; and a static scan of their imports."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys

BLOCKED = ("jax", "jaxlib", "dynamic_direct_lidar_odometry_tpu")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import dataclasses

import numpy as np

import chip_smoke
from dynamic_direct_lidar_odometry_tpu_torch import config
from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic

cfg = config.doals_config()
cfg = dataclasses.replace(
    cfg,
    capacity=dataclasses.replace(
        cfg.capacity, max_points=1024, max_keyframe_points=1024,
        max_keyframes=8, max_submap_points=4096,
    ),
    detection=dataclasses.replace(cfg.detection, rows=16, columns=256),
)
assert cfg.dynamic_detection
world = synthetic.World.town(seed=0)
poses = synthetic.circular_trajectory(2, radius=6.0, angle_span=0.05)
scans = [synthetic.render_scan(world, T, H=16, W=256) for T in poses]
poses_out, records = chip_smoke.run_slice(
    cfg, [s[0] for s in scans], [s[1] for s in scans], [0.0, 0.1], "cpu"
)
assert poses_out.shape == (2, 4, 4) and np.all(np.isfinite(poses_out))
assert records[0]["s2m_converged"], records
assert records[0]["detections"] > 0, records
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_and_chip_smoke_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_never_import_jax():
    jax_pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    # the JAX package under any spelling that is not the port's own name
    pkg_pat = re.compile(
        r"^\s*(import|from)\s+dynamic_direct_lidar_odometry_tpu(?!_torch)\b", re.M
    )
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dynamic_direct_lidar_odometry_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    offenders = [f for f in files if jax_pat.search(open(f).read())]
    assert not offenders, offenders
    offenders = [f for f in files if pkg_pat.search(open(f).read())]
    assert not offenders, offenders
