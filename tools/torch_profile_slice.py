"""Where a DDLO scan's time goes in the PyTorch port, on one GPU.

Runs ``bench_config()`` (full DDLO; ``--plain`` for plain DLO) over the
first scans of ``steady_state_sequence(64)`` through ``pipeline.step``
and reports, for the scans after the warm-up:

- per-stage wall time (host clock around each stage, each closed by a
  ``torch.cuda.synchronize()``): preprocess, covariances, S2S align,
  hulls + submap selection + gather, S2M align; with detection on, the
  projection (range and residual images), ground removal, CCL
  (``label_components``), ``segment_objects``, ``pca_bboxes``,
  ``tracker.update``, the static masks and the re-filter; then the
  keyframe update;
- the CCL sweeps and host reads, and the JV assignment's host reads, per
  scan;
- from ``torch.profiler`` over the same scans: device-busy time (the
  union of kernel intervals) against the wall time, i.e. the device's
  idle share, the number of kernel launches, and the top kernels by
  device time.

    python tools/torch_profile_slice.py --scans 12 --warmup 2
    python tools/torch_profile_slice.py --backends dense   # DDLO_NN_IMPL/KNN_IMPL=pallas
    python tools/torch_profile_slice.py --plain

Three replays of the same scans from a fresh state: plain (the wall
time), staged (stage timing adds synchronizations, so its own total is
printed beside the stages) and profiled (device-busy time only: the
profiler inflates the host side).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--plain", action="store_true", help="plain DLO (no detection/tracking)")
    ap.add_argument("--backends", choices=("default", "dense"), default="default",
                    help="dense: DDLO_NN_IMPL=pallas and DDLO_KNN_IMPL=pallas")
    args = ap.parse_args(argv)
    sys.path.insert(0, _ROOT)
    if args.backends == "dense":
        os.environ["DDLO_NN_IMPL"] = "pallas"
        os.environ["DDLO_KNN_IMPL"] = "pallas"

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_slice: no CUDA device", file=sys.stderr)
        return 1

    import subprocess

    from dynamic_direct_lidar_odometry_tpu_torch import config, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import odometry
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, nn_cuda, segmentation
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    cfg = config.bench_config(dynamic_detection=not args.plain)
    seq = sequence.steady_state_sequence(64)
    stages = collections.defaultdict(float)
    counting = [False]
    depth = [0]  # time the outermost stage only (no double counting)

    def timed(mod, name, label):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            if not counting[0] or depth[0]:
                return fn(*a, **k)
            sync()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*a, **k)
            finally:
                depth[0] -= 1
            sync()
            key = label(a, k) if callable(label) else label
            stages[key] += time.perf_counter() - t0
            return out

        return wrapper

    patches = [
        (odometry.prep, "preprocess", "preprocess"),
        (odometry.covariance, "plane_covariances", "covariances"),
        (odometry.gicp, "align", lambda a, k: "s2m_align" if a[7].compute_residuals else "s2s_align"),
        (odometry.kf, "convex_hull_mask", "hulls"),
        (odometry.kf, "concave_hull_mask", "hulls"),
        (odometry.kf, "select_submap", "select_submap"),
        (odometry.kf, "gather_submap", "gather_submap"),
        (odometry, "update_keyframes", "keyframe_update"),
        (detection.projection, "project_organized", "projection"),
        (detection.projection, "project_spherical", "projection"),
        (detection.projection, "project_residuals", "projection"),
        (detection.segmentation, "ground_removal", "ground_removal"),
        (detection.segmentation, "label_components", "ccl"),
        (detection.segmentation, "segment_objects", "segment_objects"),
        (detection.bbox_ops, "pca_bboxes", "pca_bboxes"),
        (pipeline.tracker, "update", "tracker_update"),
        (pipeline.tracker, "status_detection_mask", "static_masks"),
        (pipeline.filters, "decimate", "refilter"),
        (pipeline.filters, "crop_box_mask", "refilter"),
    ]
    originals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, label in patches:
        setattr(m, n, timed(m, n, label))

    scans = range(1 + args.warmup, args.scans)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def replay(staged=False, profiled=False):
        """Init + warm-up, then the measured scans (the only ones staged
        or profiled); returns (ms per scan, profiler or None)."""
        state = pipeline.init_state(cfg, seq.points[0], seq.mask[0], 0.0, device=dev)
        for i in range(1, 1 + args.warmup):
            state, _ = pipeline.step(cfg, state, seq.points[i], seq.mask[i], float(seq.stamps[i]))
        sync()
        counting[0] = staged
        segmentation.SWEEPS.clear()
        hungarian.HOST_READS.clear()
        nn_cuda.LAUNCHES.clear()
        ctx = torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:
            for i in scans:
                state, _ = pipeline.step(cfg, state, seq.points[i], seq.mask[i], float(seq.stamps[i]))
            sync()
        counting[0] = False
        return (time.perf_counter() - t0) * 1e3 / len(scans), prof

    plain_ms, _ = replay()
    per_scan = lambda c: {k: v / len(scans) for k, v in sorted(c.items())}  # noqa: E731
    counters = dict(
        ccl_per_scan=per_scan(segmentation.SWEEPS),
        jv_host_reads_per_scan=per_scan(hungarian.HOST_READS),
        nn_kernel_launches_per_scan=per_scan(nn_cuda.LAUNCHES),
    )
    staged_ms, _ = replay(staged=True)
    for m, n, fn in originals:
        setattr(m, n, fn)
    _, prof = replay(profiled=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    report = dict(
        device=torch.cuda.get_device_name(0),
        card=card,
        config="plain DLO" if args.plain else "DDLO",
        backends=args.backends,
        scans=len(scans),
        **counters,
        stage_ms_per_scan={k: v * 1e3 / len(scans) for k, v in sorted(stages.items())},
        wall_ms_per_scan=plain_ms,
        staged_wall_ms_per_scan=staged_ms,
    )
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    iv = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:  # union of kernel intervals (us)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
        calls[e.name] += 1
    report.update(
        device_busy_ms_per_scan=busy / 1e3 / len(scans),
        # busy time under the profiler, wall time of the plain replay
        device_idle_share=1.0 - busy / 1e3 / len(scans) / plain_ms,
        kernel_launches_per_scan=len(kernels) / len(scans),
        top_kernels=[
            dict(name=n[:80], ms_per_scan=t / 1e3 / len(scans), calls_per_scan=calls[n] / len(scans))
            for n, t in by_name.most_common(12)
        ],
    )
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
