"""Where a DDLO scan's time goes in the PyTorch port, on one GPU.

Runs ``bench_config()`` (full DDLO; ``--plain`` for plain DLO) over the
first scans of ``steady_state_sequence(64)`` through ``pipeline.step``
(the captured graph) and ``pipeline.step_eager`` (the same transition
driven op by op from the host) and reports, for the scans after the
warm-up:

- the wall time a scan of both (``--repeats N``: N replays of each, in
  turns, and their medians);
- from an eager replay: the CCL and JV host reads a scan and each
  hand-written kernel's launches a scan (its wrapper's count in
  ``nn_cuda.LAUNCHES``);
- from a graph replay with tracing on and no profiler
  (``utils.profiling.device_counts``): the device ms a scan of each stage
  span and of the whole graph (``span.<name>.ns``), the entry's host ms a
  step by part (``host.entry.*``) beside the host clock around the same
  entry calls, GICP's lambda trials a scan, and the wall time a scan
  with tracing on;
- from a graph replay under ``torch.profiler`` (CUDA activity only, as
  the benchmark's traced stretch) with tracing on: the same stage split,
  device-busy time (the union of kernel intervals) and idle share, the
  kernels a scan, the top kernels, the hand-written kernels' time and
  share of busy time, and the idle gaps between device operations, each
  put down to the innermost host span the host was in at the gap's
  middle (``profiling.on_profile`` maps the host spans onto the
  profiler's time base);
- each graph's capture seconds and the memory its capture reserved.

With ``--workload``, a benchmark cell's split instead: the cell set up as
``cardbench/run.py`` sets it up (its deployment, traffic and entry; the
capture and one lap), then ``--pairs`` pairs of stretches of ``--steps``
steps, tracing off and on in turns (no profiler), each step's pose read
on the host as the benchmark reads it, and one stretch of the
benchmark's traced length under ``torch.profiler`` (``Driver.traced``).
It prints scans/s with tracing off and on; from the tracing-on
stretches the same split (``profiling.split``) and the entry's parts
against the host clock around the same entry calls; from the profiled
stretch the split beside the device's busy ms a stream-scan and its idle
share.

    python tools/torch_profile_slice.py --scans 12 --warmup 2
    python tools/torch_profile_slice.py --backends dense   # DDLO_NN_IMPL/KNN_IMPL=pallas
    python tools/torch_profile_slice.py --plain
    python tools/torch_profile_slice.py --workload doals.stream1 --seed 7 --steps 600
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAND_WRITTEN = ("nn1_kernel", "knn_classes_kernel", "jv_solve_kernel", "plane_reg_kernel", "window_cov_kernel",
                "set_cond_kernel", "lm_propose_kernel", "lm_decide_kernel", "lm_inner_kernel", "span_kernel",
                "seg_count_kernel", "seg_select_kernel", "seg_stats_kernel", "seg_finish_kernel")


def idle_by_span(device, mapped) -> dict:
    """Idle seconds between device operations (``device``: (start, end)
    in us) from the first to the last, by the innermost mapped host span
    (name, start, end) around each gap's middle."""
    merged = []
    for a, b in sorted(device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle = collections.Counter()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        m = 0.5 * (a + b)
        around = [(e - s, n) for n, s, e in mapped if s <= m <= e]
        idle[min(around)[1] if around else "outside the program's spans"] += (b - a) * 1e-6
    return {k: v for k, v in idle.most_common()}


def cell_split(args) -> int:
    """``--workload``: a benchmark cell's split (the module's docstring)."""
    sys.path.insert(0, os.path.join(_ROOT, "cardbench"))
    sys.path.insert(0, _ROOT)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_slice: no CUDA device", file=sys.stderr)
        return 1
    import harness
    import run as bench_run
    import timeline

    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    bench_run._caches()
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    cell = harness.resolve(harness.load_benchmark(harness.ROOT), args.workload, harness.ROOT)
    feed = harness.make_feed(cell, args.seed, dev)
    drv = harness.Driver(cell, feed, dev)
    drv.setup()
    B = feed.streams

    def stretch(traced: bool):
        torch.cuda.synchronize()
        with profiling.device_counts(dev) if traced else contextlib.nullcontext({}) as counts:
            entry_s = []
            t0 = time.perf_counter()
            for _ in range(args.steps):
                entry_s.append(drv.step()[0])
            wall = time.perf_counter() - t0
        return args.steps * B / wall, entry_s, counts

    rates = {"off": [], "on": []}
    on = []
    for r in range(args.pairs):
        for kind in (("off", "on") if r % 2 == 0 else ("on", "off")):
            rate, entry_s, counts = stretch(kind == "on")
            rates[kind].append(rate)
            if kind == "on":
                parts = sum(counts.get(f"host.{p}.ns", 0) for p in profiling.ENTRY_SPANS) / 1e9
                on.append(dict(profiling.split(counts, args.steps * B),
                               entry_parts_over_entry_host_clock=parts / sum(entry_s)))

    prof, counts, scans = drv.traced(bench_run.TRACED_STREAM_SCANS)
    view = timeline.from_profile(prof, scans, counts, [])
    profiled = dict(profiling.split(counts, scans), device_busy_ms_per_stream_scan=view.busy_us() / 1e3 / scans,
                    device_idle_share=1.0 - view.busy_us() / (view.hi - view.lo))
    report = dict(
        workload=args.workload, seed=args.seed, device=torch.cuda.get_device_name(dev),
        card=bench_run.power_limit(), streams=B, steps_a_stretch=args.steps,
        scans_per_s={k: statistics.median(v) for k, v in rates.items()}, scans_per_s_runs=rates,
        tracing_on=on, profiled=profiled,
    )
    print(json.dumps(report, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--plain", action="store_true", help="plain DLO (no detection/tracking)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="plain replays of each kind (their median is the wall time)")
    ap.add_argument("--backends", choices=("default", "dense"), default="default",
                    help="dense: DDLO_NN_IMPL=pallas and DDLO_KNN_IMPL=pallas")
    ap.add_argument("--workload", default=None, help="a benchmark cell's split instead (BENCHMARK.json)")
    ap.add_argument("--seed", type=int, default=7, help="--workload: the cell's seed")
    ap.add_argument("--steps", type=int, default=600, help="--workload: steps a stretch")
    ap.add_argument("--pairs", type=int, default=3, help="--workload: pairs of stretches, tracing off and on")
    args = ap.parse_args(argv)
    if args.workload:
        return cell_split(args)
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
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, nn_cuda, segmentation
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling, sequence

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    cfg = config.bench_config(dynamic_detection=not args.plain)
    seq = sequence.steady_state_sequence(64)
    scans = range(1 + args.warmup, args.scans)
    n = len(scans)

    def replay(graph=True, traced=False, profiled=False):
        """Init + warm-up (the graph's capture), then the measured scans;
        returns (ms a scan, the counts or None, the profiler or None, the
        host ms of each entry call)."""
        step = pipeline.step if graph else pipeline.step_eager
        state = pipeline.init_state(cfg, seq.points[0], seq.mask[0], 0.0, device=dev)
        for i in range(1, 1 + args.warmup):
            state, _ = step(cfg, state, seq.points[i], seq.mask[i], float(seq.stamps[i]))
        sync()
        segmentation.SWEEPS.clear()
        hungarian.HOST_READS.clear()
        nn_cuda.LAUNCHES.clear()
        entry_ms = []
        with profiling.device_counts(dev) if traced else contextlib.nullcontext({}) as counts:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
                    if profiled else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                for i in scans:
                    a = time.perf_counter()
                    state, _ = step(cfg, state, seq.points[i], seq.mask[i], float(seq.stamps[i]))
                    entry_ms.append((time.perf_counter() - a) * 1e3)
                sync()
                ms = (time.perf_counter() - t0) * 1e3 / n
        return ms, (counts if traced else None), prof, entry_ms

    runs = {"eager": [], "graph": []}
    for r in range(args.repeats):
        for kind in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            runs[kind].append(replay(graph=kind == "graph")[0])
            if kind == "eager" and r == 0:
                counted = (dict(segmentation.SWEEPS), dict(hungarian.HOST_READS), dict(nn_cuda.LAUNCHES))
    wall = {k: statistics.median(v) for k, v in runs.items()}
    per_scan = lambda c: {k: v / n for k, v in sorted(c.items())}  # noqa: E731
    sweeps, reads, launched = counted

    traced_ms, counts, _, entry_ms = replay(traced=True)
    parts = sum(counts.get(f"host.{p}.ns", 0) for p in profiling.ENTRY_SPANS) / 1e6
    tracing_on = dict(wall_ms_per_scan=traced_ms, **profiling.split(counts, n),
                      entry_parts_over_entry_host_clock=parts / sum(entry_ms))
    _, pcounts, prof, _ = replay(traced=True, profiled=True)
    kernels = profiling.device_events(prof)
    busy, _ = profiling.device_busy_us(prof)
    by_name, launches = collections.Counter(), collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
        launches[e.name] += 1
    own_us = {k: sum(t for nm, t in by_name.items() if k in nm) for k in HAND_WRITTEN}
    profiled = dict(
        **profiling.split(pcounts, n),
        device_busy_ms_per_scan=busy / 1e3 / n,
        # busy time under the profiler, wall time of the plain replay
        device_idle_share=1.0 - busy / 1e3 / n / wall["graph"],
        kernel_launches_per_scan=len(kernels) / n,
        hand_written_kernels={k: dict(ms_per_scan=v / 1e3 / n,
                                      calls_per_scan=sum(c for nm, c in launches.items() if k in nm) / n,
                                      share_of_busy=v / busy if busy else None)
                              for k, v in own_us.items()},
        top_kernels=[dict(name=nm[:80], ms_per_scan=t / 1e3 / n, calls_per_scan=launches[nm] / n)
                     for nm, t in by_name.most_common(12)],
        idle_s_by_host_span=idle_by_span([(e.time_range.start, e.time_range.end) for e in kernels],
                                         profiling.on_profile(prof)),
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    report = dict(
        device=torch.cuda.get_device_name(0), card=card,
        config="plain DLO" if args.plain else "DDLO", backends=args.backends, scans=n,
        wall_ms_per_scan=wall, wall_ms_per_scan_runs=runs,
        ccl_per_scan_eager=per_scan(sweeps), jv_host_reads_per_scan_eager=per_scan(reads),
        kernel_launches_by_wrapper_per_scan_eager=per_scan(launched),
        graph_tracing_on=tracing_on, graph_profiled=profiled, graphs=pipeline.graph_stats(),
    )
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
