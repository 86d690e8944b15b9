"""Commit the JAX package's plain-DLO poses as the PyTorch port's reference.

Runs the JAX package on the CPU (its exact NN and exact k-NN covariance
paths) with ``bench_config(dynamic_detection=False)`` over the first N
scans of ``steady_state_sequence(64)`` (rendered afresh, see
``utils/sequence.py``) and writes
``tests/golden/torch_port_dlo_steady_jaxcpu.npz``:

  poses (N,4,4) f32, n_scans, ate (JAX ATE vs ground truth, m),
  keyframe_added (N-1,) bool, num_keyframes (N-1,) int,
  scans_sha256 (``sequence.sequence_sha256`` of the first N scans).

``chip_smoke.py`` holds the port's poses on the GPU against these (the
GPU host has no JAX), and uses the checksum to refuse a different
sequence.

    env JAX_PLATFORMS=cpu python tools/torch_port_reference_poses.py --scans 16
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(
    _ROOT, "tests", "golden", "torch_port_dlo_steady_jaxcpu.npz"
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    sys.path.insert(0, _ROOT)
    import jax

    from dynamic_direct_lidar_odometry_tpu import config, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics, sequence

    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu: the reference is the CPU path")

    cfg = config.bench_config(dynamic_detection=False)
    seq = sequence.steady_state_sequence(64)
    n = args.scans
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, seq.points[0], seq.mask[0], 0.0)
    poses = [np.eye(4, dtype=np.float32)]
    added, n_kf = [], []
    for i in range(1, n):
        ts = time.perf_counter()
        state, out = pipeline.step(
            cfg, state, seq.points[i], seq.mask[i], np.float32(seq.stamps[i])
        )
        poses.append(np.asarray(out.odom.T, np.float32))
        added.append(bool(out.keyframe_added))
        n_kf.append(int(state.odom.store.count))
        print(
            f"scan {i}: {time.perf_counter() - ts:.1f} s, "
            f"s2m_converged={bool(out.odom.s2m_converged)} kf={n_kf[-1]}",
            flush=True,
        )
    poses = np.stack(poses)
    ate = metrics.ate_rmse(poses[:, :3, 3], seq.gt_poses[:n])
    np.savez(
        args.out,
        poses=poses,
        n_scans=np.int32(n),
        ate=np.float64(ate),
        keyframe_added=np.asarray(added, bool),
        num_keyframes=np.asarray(n_kf, np.int32),
        scans_sha256=np.str_(sequence.sequence_sha256(seq, n)),
    )
    print(
        f"wrote {args.out}: N={n} ATE={ate * 1e3:.3f} mm "
        f"({time.perf_counter() - t0:.0f} s on the CPU)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
