"""Where a DDLO scan's time goes in the PyTorch port, on one GPU.

Runs ``bench_config()`` (full DDLO; ``--plain`` for plain DLO) over the
first scans of ``steady_state_sequence(64)`` through ``pipeline.step``
(the captured graph) and ``pipeline.step_eager`` (the same transition
driven op by op from the host) and reports, for the scans after the
warm-up:

- per-stage wall time of the eager step (host clock around each stage,
  each closed by a ``torch.cuda.synchronize()``; a graph has no stage
  edges on the host): preprocess, covariances, S2S align,
  hulls + submap selection + gather, S2M align; with detection on, the
  projection (range and residual images), ground removal, CCL
  (``label_components``), ``segment_objects``, ``pca_bboxes``,
  ``tracker.update``, the static masks and the re-filter; then the
  keyframe update;
- the eager step's CCL host reads, and the JV assignment's host reads,
  per scan; each hand-written kernel's launches per scan (its wrapper's
  count in ``nn_cuda.LAUNCHES``), beside the tracker updates (one
  ``jv_solve`` each) and covariance calls (one ``window_plane_cov`` each
  on the window path, ``regularize_plane`` on the exact one) per scan;
- from ``torch.profiler`` over the same scans, for the graph and the
  eager step: device-busy time (the union of kernel intervals) against
  the wall time, i.e. the device's idle share, the kernels run, the
  host's launch calls (``cudaLaunchKernel``, ``cudaGraphLaunch``), the
  graph's loop tests (``ddlo_set_cond``), the top kernels by device
  time, and the hand-written kernels' time and share of busy time;
- each graph's capture seconds and the memory its capture reserved;
- the device kernels a scan by stage, from the profiled eager replay:
  each stage above runs there inside a ``stage::<name>`` profiler range
  (a synchronization at both ends), and a device operation belongs to
  the range its launch falls in ("other": the step's own operations
  between stages).

    python tools/torch_profile_slice.py --scans 12 --warmup 2
    python tools/torch_profile_slice.py --backends dense   # DDLO_NN_IMPL/KNN_IMPL=pallas
    python tools/torch_profile_slice.py --plain

Replays of the same scans from a fresh state: plain (the wall time,
eager and graph in turns; ``--repeats N`` makes N of each and takes
their medians), staged (eager; stage timing adds synchronizations, so
its own total is printed beside the stages) and profiled (graph and
eager; device-busy time only: the profiler inflates the host side).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def by_stage(prof, kernels, n_scans) -> dict:
    """Device operations a scan, and their device ms, by the
    ``stage::<name>`` range they were launched in: each device operation
    is linked (by the profiler's correlation id) to the host event that
    launched it, and that event's start, on the host's clock like the
    ranges, falls in one range or in none ("other"). ``unlinked``: device
    operations that no host event claims."""
    import torch

    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len("stage::"):]) for e in cpu
                    if e.name.startswith("stage::"))
    starts = [a for a, _, _ in ranges]
    count, us = collections.Counter(), collections.Counter()
    for e in cpu:
        launched = [k for k in e.kernels if not k.name.startswith("stage::")]
        if not launched:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        stage = ranges[i][2] if i >= 0 and e.time_range.start <= ranges[i][1] else "other"
        count[stage] += len(launched)
        us[stage] += sum(k.duration for k in launched)
    count["unlinked"] = len(kernels) - sum(count.values())
    return dict(
        kernels_per_scan_by_stage={k: v / n_scans for k, v in count.most_common()},
        device_ms_per_scan_by_stage={k: us[k] / 1e3 / n_scans for k, _ in count.most_common()},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--plain", action="store_true", help="plain DLO (no detection/tracking)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="plain replays before the staged one (their median is the wall time)")
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
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling, sequence

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    cfg = config.bench_config(dynamic_detection=not args.plain)
    seq = sequence.steady_state_sequence(64)
    stages = collections.defaultdict(float)
    counting = [False]
    spans = [False]  # profiler ranges around the stages (the profiled eager replay)
    depth = [0]  # time the outermost stage only (no double counting)
    calls = collections.Counter()  # tracker updates and covariance calls

    def timed(mod, name, label):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[label if isinstance(label, str) else name] += 1
            if spans[0] and not depth[0]:
                key = label(a, k) if callable(label) else label
                sync()
                depth[0] += 1
                try:
                    with torch.profiler.record_function(f"stage::{key}"):
                        out = fn(*a, **k)
                        sync()
                finally:
                    depth[0] -= 1
                return out
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

    def replay(staged=False, profiled=False, graph=False):
        """Init + warm-up (the graph's capture), then the measured scans
        (the only ones staged or profiled); returns (ms per scan, profiler
        or None)."""
        step = pipeline.step if graph else pipeline.step_eager
        state = pipeline.init_state(cfg, seq.points[0], seq.mask[0], 0.0, device=dev)
        for i in range(1, 1 + args.warmup):
            state, _ = step(cfg, state, seq.points[i], seq.mask[i], float(seq.stamps[i]))
        sync()
        counting[0] = staged
        segmentation.SWEEPS.clear()
        hungarian.HOST_READS.clear()
        nn_cuda.LAUNCHES.clear()
        calls.clear()
        ctx = torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:
            for i in scans:
                state, _ = step(cfg, state, seq.points[i], seq.mask[i], float(seq.stamps[i]))
            sync()
        counting[0] = False
        return (time.perf_counter() - t0) * 1e3 / len(scans), prof

    plain_runs = {"eager": [], "graph": []}
    for r in range(args.repeats):
        for kind in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            ms = replay(graph=kind == "graph")[0]
            plain_runs[kind].append(ms)
            if kind == "eager" and r == 0:
                counted = (dict(segmentation.SWEEPS), dict(hungarian.HOST_READS),
                           dict(nn_cuda.LAUNCHES), dict(calls))
    plain_ms = {k: statistics.median(v) for k, v in plain_runs.items()}
    per_scan = lambda c: {k: v / len(scans) for k, v in sorted(c.items())}  # noqa: E731
    sweeps, reads, launched, calls_ = counted
    counters = dict(
        ccl_per_scan_eager=per_scan(sweeps),
        jv_host_reads_per_scan_eager=per_scan(reads),
        kernel_launches_by_wrapper_per_scan_eager=per_scan(launched),
        tracker_updates_per_scan=calls_.get("tracker_update", 0) / len(scans),
        covariance_calls_per_scan=calls_.get("covariances", 0) / len(scans),
    )
    staged_ms, _ = replay(staged=True)
    spans[0] = True
    profs = {"eager": replay(profiled=True)[1]}
    spans[0] = False
    for m, n, fn in originals:
        setattr(m, n, fn)
    pipeline.clear_graphs()  # captured with the stage wrappers
    profs["graph"] = replay(profiled=True, graph=True)[1]

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
        staged_wall_ms_per_scan_eager=staged_ms,
    )
    report["graphs"] = pipeline.graph_stats()
    for kind, prof in profs.items():
        kernels = profiling.device_events(prof)  # the stage ranges' device side left out
        busy, _ = profiling.device_busy_us(prof)  # union of kernel intervals (us)
        by_name = collections.Counter()
        launches = collections.Counter()
        for e in kernels:
            by_name[e.name] += e.time_range.end - e.time_range.start
            launches[e.name] += 1
        api = collections.Counter(e.name for e in prof.events()
                                  if e.name in ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync"))
        own_us = {k: sum(t for n, t in by_name.items() if k in n)
                  for k in ("nn1_kernel", "knn_classes_kernel", "jv_solve_kernel", "plane_reg_kernel",
                            "window_cov_kernel", "set_cond_kernel", "lm_propose_kernel", "lm_decide_kernel",
                            "lm_inner_kernel")}
        report[kind] = dict(
            wall_ms_per_scan=plain_ms[kind], wall_ms_per_scan_runs=plain_runs[kind],
            # the hand-written kernels' device time and share of busy time
            hand_written_kernels={k: dict(ms_per_scan=v / 1e3 / len(scans),
                                          calls_per_scan=sum(c for n, c in launches.items() if k in n) / len(scans),
                                          share_of_busy=v / busy if busy else None)
                                  for k, v in own_us.items()},
            device_busy_ms_per_scan=busy / 1e3 / len(scans),
            # busy time under the profiler, wall time of the plain replay
            device_idle_share=1.0 - busy / 1e3 / len(scans) / plain_ms[kind],
            kernel_launches_per_scan=len(kernels) / len(scans),
            host_launch_calls_per_scan={k: v / len(scans) for k, v in sorted(api.items())},
            top_kernels=[
                dict(name=n[:80], ms_per_scan=t / 1e3 / len(scans), calls_per_scan=launches[n] / len(scans))
                for n, t in by_name.most_common(12)
            ],
        )
        if kind == "eager":
            report[kind].update(by_stage(prof, kernels, len(scans)))
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
