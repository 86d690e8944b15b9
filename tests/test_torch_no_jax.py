"""The port and chip_smoke.py run where JAX is not installed (the GPU
host): in a subprocess with ``jax`` blocked, import them and run one
tiny plain-DLO step on the CPU through chip_smoke's own helper."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import dataclasses

import numpy as np

import chip_smoke
from dynamic_direct_lidar_odometry_tpu import config
from dynamic_direct_lidar_odometry_tpu.io import synthetic

cfg = config.doals_config(dynamic_detection=False)
cfg = dataclasses.replace(
    cfg,
    capacity=dataclasses.replace(
        cfg.capacity, max_points=1024, max_keyframe_points=1024,
        max_keyframes=8, max_submap_points=4096,
    ),
    detection=dataclasses.replace(cfg.detection, rows=16, columns=256),
)
world = synthetic.World.town(seed=0)
poses = synthetic.circular_trajectory(2, radius=6.0, angle_span=0.05)
scans = [synthetic.render_scan(world, T, H=16, W=256) for T in poses]
poses_out, records = chip_smoke.run_slice(
    cfg, [s[0] for s in scans], [s[1] for s in scans], [0.0, 0.1], "cpu"
)
assert poses_out.shape == (2, 4, 4) and np.all(np.isfinite(poses_out))
assert records[0]["s2m_converged"], records
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]
assert not [m for m in bad if sys.modules[m] is not None], bad
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
    import re

    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dynamic_direct_lidar_odometry_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders
