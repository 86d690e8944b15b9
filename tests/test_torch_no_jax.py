"""The port and chip_smoke.py run where JAX is not installed (the GPU
host) and never import the JAX package: in a subprocess with ``jax`` and
``dynamic_direct_lidar_odometry_tpu`` (and their submodules) blocked,
import them and run one tiny full-DDLO step on the CPU through
chip_smoke's own helper, two scans of ``runner.replay``, the CLI's
``synth``, ``parallel.replay.replay_batch`` (2 streams, 2 scans),
``pipeline.step_chunk``, a binary ``io.pcd.save_pcd`` through
``io.native`` and ``point_parallel_pipeline_step`` in a world of one
``parallel.distributed`` rank, run a ``core/control.while_loop``, and
load ``tools/torch_accuracy.py``; a
static scan of their imports (that tool's and ``tools/torch_profile_slice.py``'s
too); and a scan of the CUDA sources' includes."""

import os
import re
import subprocess
import sys

import pytest

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
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic

import torch

turns = torch.zeros((), dtype=torch.int32)
control.while_loop(lambda t: t < 3, lambda t: t.add_(1), (turns,))
assert int(turns) == 3

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

import os
import tempfile

from dynamic_direct_lidar_odometry_tpu_torch import cli, runner
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset

seq = dataset.ScanSequence(
    points=np.stack([s[0] for s in scans]), mask=np.stack([s[1] for s in scans]),
    stamps=np.array([0.0, 0.1]), H=16, W=256,
)
with tempfile.TemporaryDirectory() as d:
    res = runner.replay(cfg, seq, out_dir=d, map_capacity=20_000, device="cpu")
    assert res.poses.shape == (1, 3) and np.all(np.isfinite(res.poses)), res.poses
    assert os.path.exists(os.path.join(d, "map.pcd"))
    path = os.path.join(d, "s.npz")
    assert cli.main(["synth", "--scans", "2", "--rows", "8", "--cols", "64", "--out", path]) == 0
    assert len(dataset.ScanSequence.load(path)) == 2
import importlib.util

spec = importlib.util.spec_from_file_location("torch_accuracy", os.path.join("tools", "torch_accuracy.py"))
accuracy = importlib.util.module_from_spec(spec)
spec.loader.exec_module(accuracy)
run = dict(poses=res.poses, stamps=res.stamps, dropped=res.dropped_scans)
assert accuracy.pairwise_ate(run, run) == 0.0 == accuracy.max_divergence(run, run)
import torch

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.parallel import replay, sharding

pts2 = np.stack([np.stack([s[0] for s in scans])] * 2)
msk2 = np.stack([np.stack([s[1] for s in scans])] * 2)
rb = replay.replay_batch(cfg, pts2, msk2, np.array([[0.0, 0.1]] * 2),
                         mesh=sharding.make_mesh(1, devices=["cpu"]))
assert rb.poses.shape == (2, 1, 3) and np.allclose(rb.poses[0], rb.poses[1]), rb.poses
st = pipeline.init_state(cfg, scans[0][0], scans[0][1], 0.0, device="cpu")
st, outs = pipeline.step_chunk(cfg, st, pts2[0][1:], msk2[0][1:], torch.tensor([0.1]))
assert outs.odom.pose.shape == (1, 3) and np.allclose(outs.odom.pose[0].numpy(), rb.poses[0, 0])
import socket

import torch.distributed as dist

from dynamic_direct_lidar_odometry_tpu_torch.core import tree
from dynamic_direct_lidar_odometry_tpu_torch.io import native, pcd
from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed

assert native.available()
with tempfile.TemporaryDirectory() as d:
    assert pcd.save_pcd(os.path.join(d, "a.pcd"), pts2[0, 0], msk2[0, 0]) == int(msk2[0, 0].sum())
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
distributed.initialize(f"127.0.0.1:{port}", 1, 0)
mesh = sharding.make_mesh(1, devices=["cpu"])
step = sharding.point_parallel_pipeline_step(cfg, mesh)
st1 = tree.stack([pipeline.init_state(cfg, scans[0][0], scans[0][1], 0.0, device="cpu")])
_, pp = step(st1, pts2[:1, 1], msk2[:1, 1], np.array([0.1], np.float32))
assert np.allclose(pp.odom.pose[0].numpy(), rb.poses[0, 0]), (pp.odom.pose, rb.poses[0, 0])
(total,) = distributed.allsum([torch.ones(3)], dist.group.WORLD)
assert total.tolist() == [1.0, 1.0, 1.0]
dist.destroy_process_group()
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
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "torch_accuracy.py"),
             os.path.join(ROOT, "tools", "torch_profile_slice.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dynamic_direct_lidar_odometry_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    assert os.path.join(ROOT, "dynamic_direct_lidar_odometry_tpu_torch", "core", "control.py") in files
    offenders = [f for f in files if jax_pat.search(open(f).read())]
    assert not offenders, offenders
    offenders = [f for f in files if pkg_pat.search(open(f).read())]
    assert not offenders, offenders


def _cuda_sources():
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    return sorted({s for srcs in nn_cuda._SOURCES.values() for s in srcs})


@pytest.mark.parametrize("source", _cuda_sources())
def test_cuda_sources_are_hand_written_with_a_plain_c_interface(source):
    """Every CUDA source the port builds (``nn_cuda._SOURCES``: the NN
    kernels, ``jv_solve.cu``, ``plane_reg.cu``) lies in the package's
    ``csrc/``, is bound through ``extern "C"`` (no PyTorch headers, so
    ``nvcc`` builds it in seconds) and calls no library of finished
    kernels."""
    path = os.path.join(ROOT, "dynamic_direct_lidar_odometry_tpu_torch", "csrc", source)
    text = open(path).read()
    assert 'extern "C"' in text and "__global__" in text
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text, re.M)
    banned = ("torch", "ATen", "c10", "cublas", "cudnn", "cusparse", "cufft", "thrust", "cub/", "cutlass",
              "jax", "xla")
    assert not [i for i in includes if i.startswith(banned)], includes
