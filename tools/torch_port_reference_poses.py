"""Commit the JAX package's poses as the PyTorch port's reference.

Runs the JAX package on the CPU (its exact NN and exact k-NN covariance
paths) at ``bench_config()`` over the first N scans of
``steady_state_sequence(64)`` (rendered afresh by the port's own
``io.dataset``, see ``utils/sequence.py``) and writes, for plain DLO
(``dynamic_detection=False``, the default),
``tests/golden/torch_port_dlo_steady_jaxcpu.npz``:

  poses (N,4,4) f32, n_scans, ate (JAX ATE vs ground truth, m),
  keyframe_added (N-1,) bool, num_keyframes (N-1,) int,
  scans_sha256 (``sequence.sequence_sha256`` of the first N scans);

and with ``--dynamic`` (full DDLO, detection and tracking on)
``tests/golden/torch_port_ddlo_steady_jaxcpu.npz`` with, besides those,

  detections (N-1,) int: valid detection slots per scan,
  track_status (N-1, 3) int: active tracks per status
  (UNDEFINED, STATIC, DYNAMIC) after each scan.

With ``--replay`` it runs the JAX package's replay surface instead
(``runner.replay`` with ``hulls="device"``, the port's default) and
writes, from ``bench_config()`` over the first N scans,
``tests/golden/torch_port_replay_steady_jaxcpu.npz``; and from the
configuration the JAX ``cli run`` builds for the 64 x 2048 sequence
(``doals_config`` + ``capacity_for_scan``: 128 keyframes, a 65,536-point
cloud, a 262,144-point submap) over the first ``--cli-scans`` scans,
``tests/golden/torch_port_cli_steady_jaxcpu.npz``. Each holds

  poses (S,3) f32, quats (S,4) f32 wxyz, stamps (S,), n_scans,
  num_keyframes, map_points, dynamic_counts (S,) int, ate (m),
  scans_sha256.

The CLI run goes through the JAX ``cli.main(["run", ...])`` itself, with
``runner.replay`` wrapped to pass ``hulls="device"``, so its
configuration is the one ``_cmd_run`` builds. ``--replay bench`` or
``--replay cli`` writes one of the two.

With ``--kantplatz`` it runs ``kantplatz_config()`` at its published
512 x 512 with the capacity the CLI gives such a dataset
(``capacity_for_scan(512, 512)``: a 65,536-point cloud, a 262,144-point
submap, 128 keyframes of 32,768 points, 32 objects and tracks) over
``utils.sequence.kantplatz_sequence`` (6 scans) and writes
``tests/golden/torch_port_kantplatz512_jaxcpu.npz``:

  poses (N,4,4) f32, keyframe_added (N-1,) bool, num_keyframes,
  s2m_converged, detections (valid detection slots per scan),
  outside_window (labelled pixels outside the segmentation window, per
  scan), ate (m), scans_sha256.

With ``--accuracy`` it writes the two 64-scan trajectories the port's
accuracy tool (``tools/torch_accuracy.py``) holds its card legs to: the
JAX package's ``runner.replay(bench_config(), steady_state_sequence(64),
hulls="device")``, as ``tools/accuracy_tpu.py`` replays it, under

  exact:  ``DDLO_NN_IMPL=exact`` and ``DDLO_KNN_IMPL=exact`` (that tool's
          ``cpu_exact`` leg), ``tests/golden/torch_port_accuracy64_jaxcpu_exact.npz``;
  window: the default environment with only ``ops/covariance``'s backend
          test answering ``"tpu"`` (the Morton-window covariances; every
          other dispatch stays on the CPU's exact sweeps, and the sparse
          1-NN's residual clamp is the CPU's own), which is the function the
          port's card default computes,
          ``tests/golden/torch_port_accuracy64_jaxcpu_window.npz``.

Each holds the replay fields above plus ``dropped``, ``keyframe_added``
(per ``pipeline.step`` call), ``seconds`` (the JAX CPU run's wall time)
and ``ate`` aligned by stamp as the JAX tool's
``child_main`` computes it. No Pallas kernel may run: every ``nn_pallas``
entry point is replaced by one that raises for the run. ``--accuracy``
alone writes both, each in a process of its own (the backend test is read
at trace time, and traces are cached); ``--accuracy exact|window`` one.

``chip_smoke.py`` holds the port's runs on the GPU against these (the
GPU host has no JAX), and uses the checksum to refuse a different
sequence.

    env JAX_PLATFORMS=cpu python tools/torch_port_reference_poses.py --scans 16
    env JAX_PLATFORMS=cpu python tools/torch_port_reference_poses.py --scans 16 --dynamic
    env JAX_PLATFORMS=cpu python tools/torch_port_reference_poses.py --replay [bench|cli]
    env JAX_PLATFORMS=cpu python tools/torch_port_reference_poses.py --kantplatz
    env JAX_PLATFORMS=cpu python tools/torch_port_reference_poses.py --accuracy
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLDEN = os.path.join(_ROOT, "tests", "golden")
DEFAULT_OUT = os.path.join(_GOLDEN, "torch_port_dlo_steady_jaxcpu.npz")
DYNAMIC_OUT = os.path.join(_GOLDEN, "torch_port_ddlo_steady_jaxcpu.npz")
REPLAY_OUT = os.path.join(_GOLDEN, "torch_port_replay_steady_jaxcpu.npz")
CLI_OUT = os.path.join(_GOLDEN, "torch_port_cli_steady_jaxcpu.npz")
KANTPLATZ_OUT = os.path.join(_GOLDEN, "torch_port_kantplatz512_jaxcpu.npz")
ACCURACY_OUT = {
    leg: os.path.join(_GOLDEN, f"torch_port_accuracy64_jaxcpu_{leg}.npz") for leg in ("exact", "window")
}
ACCURACY_ENV = {"exact": {"DDLO_NN_IMPL": "exact", "DDLO_KNN_IMPL": "exact"}, "window": {}}


def _jax_sequence(seq, n):
    from dynamic_direct_lidar_odometry_tpu.io import dataset

    return dataset.ScanSequence(
        points=seq.points[:n], mask=seq.mask[:n], stamps=seq.stamps[:n],
        H=seq.H, W=seq.W, gt_poses=seq.gt_poses[:n],
    )


def _save_replay(path, res, seq, n, seconds):
    from dynamic_direct_lidar_odometry_tpu import runner
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    ate = runner.ate_rmse(res.poses, seq.gt_poses[:n])
    np.savez(
        path,
        poses=np.asarray(res.poses, np.float32),
        quats=np.asarray(res.quats, np.float32),
        stamps=np.asarray(res.stamps, np.float64),
        n_scans=np.int32(n),
        num_keyframes=np.int32(res.num_keyframes),
        map_points=np.int32(res.map_points),
        dynamic_counts=np.asarray(res.dynamic_counts, np.int32),
        ate=np.float64(ate),
        scans_sha256=np.str_(sequence.sequence_sha256(seq, n)),
    )
    print(
        f"wrote {path}: N={n} keyframes={res.num_keyframes} "
        f"map_points={res.map_points} ATE={ate * 1e3:.3f} mm "
        f"({seconds:.0f} s on the CPU)", flush=True,
    )


def replay_goldens(which: str, n_bench: int, n_cli: int) -> None:
    import tempfile

    from dynamic_direct_lidar_odometry_tpu import cli, config, runner
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    seq = sequence.steady_state_sequence(64)
    if which in ("all", "bench"):
        t0 = time.perf_counter()
        res = runner.replay(
            config.bench_config(), _jax_sequence(seq, n_bench), hulls="device", progress=True
        )
        _save_replay(REPLAY_OUT, res, seq, n_bench, time.perf_counter() - t0)
    if which in ("all", "cli"):
        got = {}
        real = runner.replay

        def device_hulls(*a, **kw):
            got["res"] = real(*a, **dict(kw, hulls="device"))
            return got["res"]

        t0 = time.perf_counter()
        runner.replay = device_hulls
        try:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "seq.npz")
                _jax_sequence(seq, n_cli).save(path)
                cli.main(["run", "--dataset", path])
        finally:
            runner.replay = real
        _save_replay(CLI_OUT, got["res"], seq, n_cli, time.perf_counter() - t0)


def kantplatz_golden(out_path: str) -> None:
    import dataclasses

    from dynamic_direct_lidar_odometry_tpu import config, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
    from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics, sequence

    seq = sequence.kantplatz_sequence()
    n = len(seq)
    cfg = dataclasses.replace(config.kantplatz_config(), capacity=config.capacity_for_scan(512, 512))
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, seq.points[0], seq.mask[0], 0.0)
    poses = [np.eye(4, dtype=np.float32)]
    added, conv, dets, outside = [], [], [], []
    for i in range(1, n):
        ts = time.perf_counter()
        state, out = pipeline.step(cfg, state, seq.points[i], seq.mask[i], np.float32(seq.stamps[i]))
        poses.append(np.asarray(out.odom.T, np.float32))
        added.append(bool(out.keyframe_added))
        conv.append(bool(out.odom.s2m_converged))
        dets.append(int(np.asarray(out.detections.objects.valid).sum()))
        # the port's window check reads only cfg.detection, which both packages share
        outside.append(detection.labels_outside_window(cfg, np.array(out.detections.labels)))
        print(f"scan {i}: {time.perf_counter() - ts:.1f} s, kf={added[-1]} s2m_converged={conv[-1]} "
              f"detections={dets[-1]} outside_window={outside[-1]}", flush=True)
    poses = np.stack(poses)
    ate = metrics.ate_rmse(poses[:, :3, 3], seq.gt_poses)
    np.savez(
        out_path, poses=poses, keyframe_added=np.asarray(added, bool),
        num_keyframes=np.int32(state.odom.store.count), s2m_converged=np.asarray(conv, bool),
        detections=np.asarray(dets, np.int32), outside_window=np.asarray(outside, np.int32),
        ate=np.float64(ate), scans_sha256=np.str_(sequence.sequence_sha256(seq, n)),
    )
    print(f"wrote {out_path}: N={n} ATE={ate * 1e3:.3f} mm ({time.perf_counter() - t0:.0f} s on the CPU)")


class _TpuBackendProxy:
    """``jax`` for one module, except that ``default_backend()`` says "tpu"."""

    def __init__(self, jax_mod):
        self._jax = jax_mod

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def default_backend(self):
        return "tpu"


def accuracy_golden(leg: str, n: int = 64) -> None:
    import jax

    from dynamic_direct_lidar_odometry_tpu import config, runner
    from dynamic_direct_lidar_odometry_tpu.ops import covariance, nn_pallas
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    for k in ("DDLO_NN_IMPL", "DDLO_KNN_IMPL"):
        os.environ.pop(k, None)
    os.environ.update(ACCURACY_ENV[leg])
    pallas_calls, window_traces = [], []

    def refuse(name):
        def call(*a, **kw):
            pallas_calls.append(name)
            raise RuntimeError(f"nn_pallas.{name} reached: a Pallas kernel would run in interpret mode")
        return call

    for name in ("nn1_pallas", "nn1_sparse_prepared", "nn1_sparse_pallas", "knn_approx_pallas",
                 "prepare_sparse_target"):
        setattr(nn_pallas, name, refuse(name))
    if leg == "window":
        covariance.jax = _TpuBackendProxy(jax)
        real_window = covariance._window_self_covariances

        def window(*a, **kw):
            window_traces.append(1)
            return real_window(*a, **kw)

        covariance._window_self_covariances = window

    flags = []
    real_step = runner.pipeline.step

    def step(*a, **kw):
        state, out = real_step(*a, **kw)
        flags.append(out.keyframe_added)
        return state, out

    seq = sequence.steady_state_sequence(64)
    t0 = time.perf_counter()
    runner.pipeline.step = step
    try:
        res = runner.replay(config.bench_config(), _jax_sequence(seq, n), hulls="device", progress=True)
    finally:
        runner.pipeline.step = real_step
    seconds = time.perf_counter() - t0
    if pallas_calls:
        raise SystemExit(f"Pallas entry points reached: {sorted(set(pallas_calls))}")
    if leg == "window" and not window_traces:
        raise SystemExit("the window covariance path was never traced")
    ate = runner.ate_rmse(res.poses, seq.gt_poses[:n], res.stamps, seq.stamps[:n])
    path = ACCURACY_OUT[leg]
    np.savez(
        path,
        poses=np.asarray(res.poses, np.float32),
        quats=np.asarray(res.quats, np.float32),
        stamps=np.asarray(res.stamps, np.float64),
        n_scans=np.int32(n),
        num_keyframes=np.int32(res.num_keyframes),
        map_points=np.int32(res.map_points),
        dynamic_counts=np.asarray(res.dynamic_counts, np.int32),
        dropped=np.int32(res.dropped_scans),
        keyframe_added=np.asarray([bool(f) for f in flags], bool),
        ate=np.float64(ate),
        seconds=np.float64(seconds),
        scans_sha256=np.str_(sequence.sequence_sha256(seq, n)),
    )
    print(
        f"wrote {path}: N={n} keyframes={res.num_keyframes} map_points={res.map_points} "
        f"dropped={res.dropped_scans} ATE={ate * 1e3:.3f} mm ({seconds:.0f} s on the CPU)", flush=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--dynamic", action="store_true", help="full DDLO (detection + tracking)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--replay", nargs="?", const="all", choices=("all", "bench", "cli"),
                    help="the replay goldens (runner.replay and cli run) instead")
    ap.add_argument("--cli-scans", type=int, default=8)
    ap.add_argument("--kantplatz", action="store_true",
                    help="kantplatz_config() at 512 x 512 over kantplatz_sequence() instead")
    ap.add_argument("--accuracy", nargs="?", const="all", choices=("all", "exact", "window"),
                    help="the accuracy tool's 64-scan JAX CPU trajectories instead")
    args = ap.parse_args(argv)
    out_path = args.out or (DYNAMIC_OUT if args.dynamic else DEFAULT_OUT)

    sys.path.insert(0, _ROOT)
    import jax

    from dynamic_direct_lidar_odometry_tpu import config, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics, sequence

    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu: the reference is the CPU path")
    if args.replay:
        replay_goldens(args.replay, args.scans, args.cli_scans)
        return 0
    if args.kantplatz:
        kantplatz_golden(args.out or KANTPLATZ_OUT)
        return 0
    if args.accuracy == "all":
        import subprocess

        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--accuracy", leg])
                 for leg in ("exact", "window")]
        return max(p.wait() for p in procs)
    if args.accuracy:
        accuracy_golden(args.accuracy)
        return 0

    cfg = config.bench_config(dynamic_detection=args.dynamic)
    seq = sequence.steady_state_sequence(64)
    n = args.scans
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, seq.points[0], seq.mask[0], 0.0)
    poses = [np.eye(4, dtype=np.float32)]
    added, n_kf, dets, status = [], [], [], []
    for i in range(1, n):
        ts = time.perf_counter()
        state, out = pipeline.step(
            cfg, state, seq.points[i], seq.mask[i], np.float32(seq.stamps[i])
        )
        poses.append(np.asarray(out.odom.T, np.float32))
        added.append(bool(out.keyframe_added))
        n_kf.append(int(state.odom.store.count))
        dets.append(int(np.asarray(out.detections.objects.valid).sum()))
        act = np.asarray(state.tracks.active)
        st = np.asarray(state.tracks.status)[act]
        status.append([int((st == s).sum()) for s in range(3)])
        print(
            f"scan {i}: {time.perf_counter() - ts:.1f} s, "
            f"s2m_converged={bool(out.odom.s2m_converged)} kf={n_kf[-1]} "
            f"detections={dets[-1]} status={status[-1]}",
            flush=True,
        )
    poses = np.stack(poses)
    ate = metrics.ate_rmse(poses[:, :3, 3], seq.gt_poses[:n])
    extra = {}
    if args.dynamic:
        extra = dict(
            detections=np.asarray(dets, np.int32),
            track_status=np.asarray(status, np.int32),
        )
    np.savez(
        out_path,
        poses=poses,
        n_scans=np.int32(n),
        ate=np.float64(ate),
        keyframe_added=np.asarray(added, bool),
        num_keyframes=np.asarray(n_kf, np.int32),
        scans_sha256=np.str_(sequence.sequence_sha256(seq, n)),
        **extra,
    )
    print(
        f"wrote {out_path}: N={n} ATE={ate * 1e3:.3f} mm "
        f"({time.perf_counter() - t0:.0f} s on the CPU)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
