"""Run one cell of the port's benchmark once on the card.

    python cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's deployment, traffic mix, limits
and per-layer metric readers are found by the names in ``BENCHMARK.json``
(see ``harness.py``). Set-up renders the lap on the card from the seed,
copies it into pinned host memory, starts every stream on its first scan,
captures the entry's graph and drives one whole lap. The window then
hands scans to the entry for ``--seconds`` seconds, reading each pose on
the host before the next scan. ``--trace 1`` adds a profiled stretch
after the window and reports the per-layer metrics in place of the
end-to-end ones. After the window the reference judges the outputs of
the window's first lap (driven on past the window, untimed, where the
window did not reach its end).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
``--trace 1``, and ``checks``: each compared number beside its limit).
Without a card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; with a JAX module loaded by the end of the
run (the window, the trace, the judging and the metric readers), with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the JAX side, by top-level module name: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamic_direct_lidar_odometry_tpu")
# stream-scans the traced stretch profiles
TRACED_STREAM_SCANS = 48


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc outputs go to ``build/ddlo_torch_kernels``)."""
    cache = ROOT / "build" / "cardbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))

    import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.resolve(bench, args.workload, ROOT)

    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    card = power_limit()

    import timeline

    from reference import judge

    feed = harness.make_feed(cell, args.seed, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    drv = harness.Driver(cell, feed, dev)
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    graphs = drv.graph_stats()

    drv.window(args.seconds)
    view = None
    if args.trace:
        prof, counts, scans = drv.traced(TRACED_STREAM_SCANS)
        view = timeline.from_profile(prof, scans, counts, [e * 1e3 for e in drv.rec.entry_s])
        del prof
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    drv.release()

    rec = drv.rec
    B = feed.streams
    numbers = harness.judge_run(cell, feed, rec)
    checks = judge.compare(numbers, cell.limits)
    failed = harness.failed_scans(rec)
    correct = failed == 0 and all(c["ok"] for c in checks.values())

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"], ROOT)(view)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        import stats

        lat_ms = [x * 1e3 for x in rec.latency_s]
        e2e = dict(
            scans_per_s=lambda: stats.rate(len(lat_ms) * B, rec.window_s),
            scan_ms_p95=lambda: stats.percentile(lat_ms, 95),
            setup_s=lambda: setup_s,
        )
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=e2e[m["name"]](), unit=m["unit"])

    device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=chips,
                  memory_peak_bytes=int(peak), card=card)
    if view is not None:
        device.update(timeline.summary(view))
    result = dict(correct=bool(correct), attempted=(len(rec.T) - rec.window_first) * B, failed=failed,
                  metrics=metrics, device=device)
    if view is not None:
        result["breakdown"] = timeline.breakdown(view)
    info = dict(window_steps=len(rec.latency_s), window_s=rec.window_s, streams=B,
                graphs=graphs, scan_ms_p50=(sorted(rec.latency_s)[len(rec.latency_s) // 2] * 1e3
                                            if rec.latency_s else None))
    if view is not None:
        per = view.device_ops_per_step()
        info.update(counts=view.counts, traced_steps=len(per),
                    device_ops_per_step_min=min(per, default=None), device_ops_per_step_max=max(per, default=None))
    print("cardbench: " + json.dumps(info), file=sys.stderr)
    checks["failed_scans"] = dict(value=failed, limit=0, ok=failed == 0)
    result["checks"] = {k: dict(value=c["value"], limit=c["limit"]) for k, c in checks.items()}
    bad = loaded_forbidden()  # after everything that ran in this process
    if bad:
        print(f"cardbench: JAX-side modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k}: {c['value']} limit {c['limit']} {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
