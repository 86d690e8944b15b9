#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: a CUDA card is required; prints its name and power limit
   (``nvidia-smi``) and checks that TF32 is off.
2. Build: compiles ``csrc/nn1_sparse.cu`` with nvcc for sm_90a.
3. Kernel vs its plain PyTorch version, on the card, at the main path's
   shapes (S2M 16,384 x 65,536 at r = 2 and 6, S2S 16,384 x 16,384 at
   r = 1) with queries and targets built from the benchmark sequence,
   plus one case with sentinels and non-multiple sizes. Pass: identical
   index and squared distance (|diff| = 0) on every in-radius query,
   out-of-radius queries >= r^2 in both. Times: CUDA events, median of 20.
4. Slice: plain DLO (``bench_config(dynamic_detection=False)``) on the
   first N scans of ``steady_state_sequence(64)`` (rendered afresh and
   checked against the committed checksum of those scans) through
   ``pipeline.init_state`` / ``pipeline.step`` on the card. Pass: every
   scan's S2M converged, the kernel's launch count covers every GICP
   linearization, and the poses stay within 10 mm of the committed JAX
   CPU poses (``tests/golden/torch_port_dlo_steady_jaxcpu.npz``, written
   by ``tools/torch_port_reference_poses.py``).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_dlo_steady_jaxcpu.npz")
DIVERGENCE_BAR_M = 0.010  # the ACCURACY_r05.json default-vs-exact bar
WARMUP_SCANS = 2
KERNEL = {
    "name": "nn1_sparse",
    "route": "cuda",
    "source": "dynamic_direct_lidar_odometry_tpu_torch/csrc/nn1_sparse.cu",
    "replaces": "dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:181",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median per-call time of ``fn`` on the card (CUDA events)."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_slice(cfg, points, masks, stamps, device, timed: bool = False):
    """Plain DLO through the port's public entry points: init on scan 0,
    then ``pipeline.step`` per scan. Returns poses (N,4,4) and per-scan
    records; with ``timed`` each step is timed with CUDA events."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline

    state = pipeline.init_state(cfg, points[0], masks[0], float(stamps[0]), device=device)
    poses = [state.odom.T.cpu().numpy()]
    records = []
    for i in range(1, len(points)):
        if timed:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        state, out = pipeline.step(cfg, state, points[i], masks[i], float(stamps[i]))
        rec = dict(
            s2m_converged=bool(out.odom.s2m_converged),
            s2s_iterations=int(out.odom.s2s_iterations),
            s2m_iterations=int(out.odom.s2m_iterations),
            keyframe_added=bool(out.keyframe_added),
            num_keyframes=int(state.odom.store.count),
            submap_size=int(out.odom.submap_size),
        )
        if timed:
            b.record()
            b.synchronize()
            rec["ms"] = a.elapsed_time(b)
        poses.append(out.odom.T.cpu().numpy())
        records.append(rec)
    return np.stack(poses), records


def kernel_cases(cfg, seq, ref_poses, device):
    """Kernel inputs at the main path's shapes from the benchmark
    sequence: the last reference scan, preprocessed and placed at its
    JAX pose, queried against the previous scan (S2S shape) and against
    a submap gathered from keyframes of earlier scans at their JAX poses
    (S2M shape); plus a sentinel / non-multiple case."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import se3
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
    from dynamic_direct_lidar_odometry_tpu_torch.ops import filters

    def scan_world(i):
        raw = torch.as_tensor(seq.points[i], device=device)
        p = preprocess.preprocess(cfg, raw, torch.as_tensor(seq.mask[i], device=device))
        T = torch.as_tensor(ref_poses[i], device=device)
        return torch.where(p.mask[:, None], se3.transform_points(T, p.points), 1.0e6), p.mask

    n = len(ref_poses)
    query, _ = scan_world(n - 1)
    s2s_target, _ = scan_world(n - 2)
    cap = cfg.capacity
    store = kf.empty_store(cap.max_keyframes, cap.max_keyframe_points, device=device)
    for i in range(0, n - 1, 3):
        pts, m = scan_world(i)
        kp, km = filters.voxel_downsample(
            pts, m, cfg.preprocessing.voxel_submap.res, cap.max_keyframe_points
        )
        eye = torch.eye(3, device=device).expand(kp.shape[0], 3, 3)
        store = kf.add_keyframe(
            store, True, torch.as_tensor(ref_poses[i][:3, 3], device=device),
            torch.tensor([1.0, 0, 0, 0], device=device), kp, km, eye,
        )
    s2m_target, _, _ = kf.gather_submap(
        store, store.valid, cap.max_keyframes, capacity=cap.max_submap_points
    )
    s2m = cfg.gicp.s2m.max_correspondence_distance
    s2s = cfg.gicp.s2s.max_correspondence_distance
    odd_q = query[: query.shape[0] - 777].clone()
    odd_q[::13] = 1.0e6
    odd_t = s2m_target[: s2m_target.shape[0] - 333].clone()
    odd_t[::14] = 1.0e6
    return [
        ("s2m", query, s2m_target, s2m),
        ("s2m_residual", query, s2m_target, 3.0 * s2m),
        ("s2s", query, s2s_target, s2s),
        ("sentinels_nonmultiple", odd_q, odd_t, s2m),
    ]


def check_kernel(name, query, target, radius):
    """Kernel vs plain version on the same CSR lists; returns a record."""
    from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    Q, q_tile, t_chunk = query.shape[0], 1024, 512
    prep = nn_cuda.prepare_sparse_target(target, t_chunk)
    q = pad_rows(query, q_tile, 1.0e6).contiguous()
    counts, lists = nn_cuda.tile_chunk_lists(q, prep, radius, q_tile)
    args = (q, prep.tt, counts, lists, q_tile, t_chunk)
    ik, dk = nn_cuda.nn1_sparse_chunks(*args)
    ir, dr = nn_cuda.nn1_sparse_reference(*args)
    ik, dk, ir, dr = (x[:Q].cpu().numpy() for x in (ik, dk, ir, dr))
    r2 = radius * radius
    inr = dr < r2
    err = float(np.max(np.abs(dk[inr] - dr[inr]), initial=0.0))
    check(bool(np.all(ik[inr] == ir[inr])), f"{name}: kernel index differs in radius")
    check(err == 0.0, f"{name}: kernel distance differs by {err} in radius")
    check(bool(np.all(dk[~inr] >= r2)), f"{name}: kernel reports an out-of-radius query inside r")
    rec = dict(
        case=name, Q=Q, T=target.shape[0], radius=radius,
        in_radius=int(inr.sum()),
        active_chunk_share=float(counts.float().mean()) / lists.shape[1],
        max_abs_err=err,
        all_rows_identical=bool(np.all(ik == ir) and np.all(dk == dr)),
        ms=cuda_ms(lambda: nn_cuda.nn1_sparse_chunks(*args)),
        plain_ms=cuda_ms(lambda: nn_cuda.nn1_sparse_reference(*args)),
    )
    print("kernel check " + json.dumps(rec), flush=True)
    return rec


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import dynamic_direct_lidar_odometry_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from dynamic_direct_lidar_odometry_tpu import config
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda
    from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics, sequence

    card = card_line()
    print(f"card: {card}", flush=True)
    check(
        not torch.backends.cuda.matmul.allow_tf32
        and not torch.backends.cudnn.allow_tf32
        and torch.get_float32_matmul_precision() == "highest",
        "TF32 is on",
    )
    dev = torch.device("cuda", 0)

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = nn_cuda.build()
    print(f"build: {built.path.name} in {time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s)", flush=True)
    if built.log:
        print(built.log.strip(), flush=True)

    ref = np.load(GOLDEN)
    n = int(ref["n_scans"])
    ref_poses = ref["poses"]
    cfg = config.bench_config(dynamic_detection=False)
    t0 = time.perf_counter()
    seq = sequence.steady_state_sequence(64)
    print(f"sequence: 64 scans {seq.H}x{seq.W} in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    digest = sequence.sequence_sha256(seq, n)
    check(
        digest == str(ref["scans_sha256"]),
        f"scans 0-{n - 1} differ from the reference sequence (sha256 {digest})",
    )

    # ---- 3. kernel vs plain ----
    records = [check_kernel(*c) for c in kernel_cases(cfg, seq, ref_poses, dev)]

    # ---- 4. slice ----
    nn_cuda.LAUNCHES["nn1_sparse"] = 0
    poses, steps = run_slice(
        cfg, seq.points[:n], seq.mask[:n], seq.stamps[:n], dev, timed=True
    )
    launches = nn_cuda.LAUNCHES["nn1_sparse"]
    linearizations = sum(r["s2s_iterations"] + r["s2m_iterations"] + 1 for r in steps)
    check(all(r["s2m_converged"] for r in steps), "an S2M registration did not converge")
    check(launches >= linearizations > 0, f"kernel launched {launches} times for {linearizations} linearizations")
    check(bool(np.all(np.isfinite(poses))) and poses.shape == (n, 4, 4), "poses not finite / wrong shape")
    div = np.linalg.norm(poses[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    ate = metrics.ate_rmse(poses[:, :3, 3], seq.gt_poses[:n])
    ms = [r["ms"] for r in steps[WARMUP_SCANS:]]
    med = statistics.median(ms)
    added = [r["keyframe_added"] for r in steps]
    print(
        "slice " + json.dumps(dict(
            scans=n, card=card,
            max_divergence_mm=float(div.max()) * 1e3,
            ate_port_mm=ate * 1e3, ate_jax_cpu_mm=float(ref["ate"]) * 1e3,
            keyframes=steps[-1]["num_keyframes"],
            keyframe_flags_match_jax=added == ref["keyframe_added"].tolist(),
            submap_size_last=steps[-1]["submap_size"],
            launches=launches, linearizations=linearizations,
            s2s_iterations=[r["s2s_iterations"] for r in steps],
            s2m_iterations=[r["s2m_iterations"] for r in steps],
            step_ms=ms, median_ms=med, hz=1e3 / med,
        )),
        flush=True,
    )
    check(float(div.max()) <= DIVERGENCE_BAR_M, f"poses diverge {div.max() * 1e3:.3f} mm from JAX")

    main_case = records[0]
    kernels = [dict(
        KERNEL, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in records),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
    )]
    print(card)  # name, power.limit exactly as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
