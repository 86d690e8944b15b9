#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (the check)
    python3 chip_smoke.py --phases 1,2,3  # a subset, e.g. after a kernel edit

Phases, in order; any failure exits non-zero and prints no result:

1. Device: a CUDA card is required; prints its name and power limit
   (``nvidia-smi``) and checks that TF32 is off.
2. Build: compiles ``csrc/nn1_sparse.cu`` and ``csrc/knn_classes.cu`` with
   nvcc for sm_90a, one nvcc each, both started together.
3. Every kernel against its plain PyTorch version, on the card, at the
   main paths' shapes, with inputs built from the benchmark sequence:
   sparse 1-NN (S2M 16,384 x 65,536 at r = 2 and 6, S2S 16,384 x 16,384
   at r = 1), dense 1-NN (16,384 x 16,384 and 16,384 x 65,536), lane-class
   k-NN (16,384 x 16,384 at k = 10 and 20, dense and pruned at r = 5),
   plus sentinel / non-multiple cases. Pass: identical index and distance
   on every row (the sparse 1-NN: on every in-radius row, out-of-radius
   rows >= r^2 in both). Times: CUDA events, median of 20.
4. Plain DLO (``bench_config(dynamic_detection=False)``) on the first 16
   scans of ``steady_state_sequence(64)`` (rendered afresh, checked
   against the committed checksum) through ``pipeline.init_state`` /
   ``pipeline.step``. Pass: every S2M converged, the sparse kernel covers
   every GICP linearization, poses within 10 mm of the JAX CPU poses
   (``tests/golden/torch_port_dlo_steady_jaxcpu.npz``).
5. Full DDLO (``bench_config()``: detection + tracking) on the same 16
   scans, default backends. Pass: poses within 10 mm of the JAX CPU run
   (``tests/golden/torch_port_ddlo_steady_jaxcpu.npz``), keyframe flags
   equal, every S2M converged, total valid detections within 10 % of the
   JAX total.
6. Detection and tracking of one phase-5 scan on the card against the
   port on the host, from the same inputs. Pass: labels, pixel_slot,
   valid slots, tracker integer/bool fields equal; box states and tracker
   float fields within 1e-4.
7. Full DDLO with the dense backends (``DDLO_NN_IMPL=pallas``,
   ``DDLO_KNN_IMPL=pallas``) on 8 scans. Pass: ``nn1_dense`` launched for
   every GICP linearization and residual pass, ``knn_classes`` for every
   covariance call, ``nn1_sparse`` never; poses within 10 mm of the
   golden.
8. The pruned k-NN entry point (``nn_cuda.knn_approx(prune_radius=5)``,
   as ``tools/profile_stages.py`` calls it) on the phase-7 scans'
   registration clouds.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}`` (full runs only).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DLO = os.path.join(ROOT, "tests", "golden", "torch_port_dlo_steady_jaxcpu.npz")
GOLDEN_DDLO = os.path.join(ROOT, "tests", "golden", "torch_port_ddlo_steady_jaxcpu.npz")
DIVERGENCE_BAR_M = 0.010  # the ACCURACY_r05.json default-vs-exact bar
DETECTION_BAR = 0.10  # total valid detections vs the JAX CPU run
WARMUP_SCANS = 2
DENSE_SCANS = 8
STATE_ATOL = 1e-4
PKG = "dynamic_direct_lidar_odometry_tpu_torch"
KERNELS = {
    "nn1_sparse": dict(source=f"{PKG}/csrc/nn1_sparse.cu",
                       replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:181"),
    "nn1_dense": dict(source=f"{PKG}/csrc/nn1_sparse.cu",
                      replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:89"),
    "knn_classes": dict(source=f"{PKG}/csrc/knn_classes.cu",
                        replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:339"),
    "knn_classes_sparse": dict(source=f"{PKG}/csrc/knn_classes.cu",
                               replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:356"),
}
# the bound: FP32 work at the H100 SXM's non-tensor issue rate (67 TFLOP/s
# counts an FMA as 2; these kernels issue no FMA: --fmad=false), against
# each input read once and each output written once at 3.35 TB/s
FP32_ISSUE_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
OPS_PER_PAIR = 10  # 3 sub, 3 mul, 2 add, compare, select


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


def bound_ms(pairs: float, bytes_moved: float) -> tuple:
    ops_ms = pairs * OPS_PER_PAIR / FP32_ISSUE_PER_S * 1e3
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_slice(cfg, points, masks, stamps, device, timed: bool = False, keep=None):
    """DDLO through the port's public entry points: init on scan 0, then
    ``pipeline.step`` per scan. Returns poses (N,4,4) and per-scan
    records; with ``timed`` each step is timed with CUDA events. ``keep``:
    a scan index whose step inputs and tracker state before it are kept
    in the record (for phase 6)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline

    state = pipeline.init_state(cfg, points[0], masks[0], float(stamps[0]), device=device)
    poses = [state.odom.T.cpu().numpy()]
    records = []
    for i in range(1, len(points)):
        before = state
        if timed:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        state, out = pipeline.step(cfg, state, points[i], masks[i], float(stamps[i]))
        if timed:
            b.record()
            b.synchronize()
        act = state.tracks.active
        st = state.tracks.status[act]
        rec = dict(
            s2m_converged=bool(out.odom.s2m_converged),
            s2s_iterations=int(out.odom.s2s_iterations),
            s2m_iterations=int(out.odom.s2m_iterations),
            keyframe_added=bool(out.keyframe_added),
            num_keyframes=int(state.odom.store.count),
            submap_size=int(out.odom.submap_size),
            detections=int(out.detections.objects.valid.sum()),
            status=[int((st == s).sum()) for s in range(3)],
        )
        if timed:
            rec["ms"] = a.elapsed_time(b)
        if i == keep:
            rec["inputs"] = dict(
                raw=torch.as_tensor(points[i], device=device), mask=torch.as_tensor(masks[i], device=device),
                reg_points=state.odom.prev_points.clone(), reg_mask=state.odom.prev_mask.clone(),
                residuals=out.odom.residuals, T=out.odom.T,
                tracks=before.tracks, dt=state.prev_stamp - before.prev_stamp,
            )
        poses.append(out.odom.T.cpu().numpy())
        records.append(rec)
    return np.stack(poses), records


def kernel_inputs(cfg, seq, ref_poses, device):
    """Inputs at the main paths' shapes from the benchmark sequence: the
    last reference scan, preprocessed and placed at its JAX pose (the
    query and, for the k-NN, its own target), the previous scan (S2S
    target) and a submap of keyframes of earlier scans (S2M target)."""
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
    s2m_target, _, _ = kf.gather_submap(store, store.valid, cap.max_keyframes,
                                        capacity=cap.max_submap_points)
    odd_q = query[: query.shape[0] - 777].clone()
    odd_q[::13] = 1.0e6
    odd_t = s2m_target[: s2m_target.shape[0] - 333].clone()
    odd_t[::14] = 1.0e6
    return query, s2s_target, s2m_target, odd_q, odd_t


def _record(kernel, case, Q, T, err, identical, pairs, nbytes, ms, plain_ms, cdist_ms, **extra):
    b, by = bound_ms(pairs, nbytes)
    rec = dict(kernel=kernel, case=case, Q=Q, T=T, max_abs_err=err, all_rows_identical=identical,
               pairs=pairs, bound_ms=b, bound_by=by, ms=ms, plain_ms=plain_ms,
               cdist_ms=cdist_ms, **extra)
    print("kernel check " + json.dumps(rec), flush=True)
    return rec


def _cdist_tiles(query, target, q_tile, cols_of_tile, k=None):
    """The nearest library yardstick: torch.cdist by differencing plus
    argmin (or topk) over the same query tiles and target columns."""
    import torch

    def run():
        for i, cols in enumerate(cols_of_tile):
            if cols is not None and cols.numel() == 0:
                continue
            qt = query[i * q_tile : (i + 1) * q_tile]
            t = target if cols is None else target[cols]
            d = torch.cdist(qt, t, compute_mode="donot_use_mm_for_euclid_dist")
            if k is None:
                torch.argmin(d, dim=1)
            else:
                torch.topk(d, k, dim=1, largest=False)

    return cuda_ms(run, reps=5)


def check_sparse(name, query, target, radius):
    """The sparse 1-NN kernel against its plain version on the same CSR lists."""
    import torch

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
    pairs = float(counts.sum()) * q_tile * t_chunk
    cols = [
        (lists[i, :c, None].long() * t_chunk + torch.arange(t_chunk, device=q.device)).reshape(-1)
        for i, c in enumerate(counts.tolist())
    ]
    tpad = prep.tt.T.contiguous()
    return _record(
        "nn1_sparse", name, Q, target.shape[0], err, bool(np.all(ik == ir) and np.all(dk == dr)),
        pairs, (q.numel() + prep.tt.numel()) * 4 + 8 * Q,
        cuda_ms(lambda: nn_cuda.nn1_sparse_chunks(*args)),
        cuda_ms(lambda: nn_cuda.nn1_sparse_reference(*args)),
        _cdist_tiles(q, tpad, q_tile, cols),
        radius=radius, in_radius=int(inr.sum()),
        active_chunk_share=float(counts.float().mean()) / lists.shape[1],
    )


def check_dense(name, query, target):
    """The dense 1-NN kernel against its plain version: every row identical."""
    from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    Q, T, t_chunk = query.shape[0], target.shape[0], 512
    q = pad_rows(query, 1024, 0.0).contiguous()
    tt = pad_rows(target, t_chunk, 1.0e6).T.contiguous()
    ik, dk = nn_cuda.nn1_dense_chunks(q, tt, t_chunk)
    ir, dr = nn_cuda.nn1_dense_reference(q, tt)
    same = bool((ik == ir).all() and (dk == dr).all())
    err = float((dk - dr).abs().max())
    check(same, f"nn1_dense {name}: kernel differs from its plain version (max |d| {err})")
    return _record(
        "nn1_dense", name, Q, T, err, same, float(Q) * T,
        (query.numel() + target.numel()) * 4 + 8 * Q,
        cuda_ms(lambda: nn_cuda.nn1_dense_chunks(q, tt, t_chunk)),
        cuda_ms(lambda: nn_cuda.nn1_dense_reference(q, tt)),
        _cdist_tiles(q, tt.T.contiguous(), 1024, [None] * (q.shape[0] // 1024)),
    )


def check_classes(name, query, target, k, prune_radius=None):
    """The lane-class k-NN kernel (dense or pruned) against its plain
    version: every row identical."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    Q, T, q_tile, t_chunk = query.shape[0], target.shape[0], 1024, 512
    q = pad_rows(query, q_tile, 0.0).contiguous()
    t = pad_rows(target, t_chunk, 1.0e6)
    tt = t.T.contiguous()
    counts = lists = None
    if prune_radius is not None:
        counts, lists = nn_cuda.class_chunk_lists(q, t, prune_radius, q_tile, t_chunk)
    args = (q, tt, counts, lists, q_tile, t_chunk, k)
    ik, dk = nn_cuda.knn_classes_chunks(*args)
    ir, dr = nn_cuda.knn_classes_reference(*args)
    same = bool((ik == ir).all() and (dk == dr).all())
    err = float((dk - dr).abs().max())
    kernel = "knn_classes" if prune_radius is None else "knn_classes_sparse"
    check(same, f"{kernel} {name}: kernel differs from its plain version (max |d| {err})")
    if counts is None:
        pairs, cols = float(q.shape[0]) * tt.shape[1], [None] * (q.shape[0] // q_tile)
    else:
        pairs = float(counts.sum()) * q_tile * t_chunk
        ar = torch.arange(t_chunk, device=q.device)
        cols = [(lists[i, :c, None].long() * t_chunk + ar).reshape(-1)
                for i, c in enumerate(counts.tolist())]
    return _record(
        kernel, name, Q, T, err, same, pairs,
        (query.numel() + target.numel()) * 4 + 8 * Q * k,
        cuda_ms(lambda: nn_cuda.knn_classes_chunks(*args)),
        cuda_ms(lambda: nn_cuda.knn_classes_reference(*args)),
        _cdist_tiles(q, t, q_tile, cols, k=k), k=k, prune_radius=prune_radius,
    )


def compare_detection(inputs, cfg):
    """Phase 6: detect + tracker.update from the same inputs on the card
    and on the host."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import interop
    from dynamic_direct_lidar_odometry_tpu_torch.core import se3
    from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
    from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
    from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker

    def run(dev):
        x = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in inputs.items()}
        tracks = type(x["tracks"])(*(t.to(dev) for t in x["tracks"]))
        seg = torch.where(x["mask"][:, None], se3.transform_points(x["T"], x["raw"]), SENTINEL)
        det = detection.detect(cfg, seg, x["mask"], x["reg_points"], x["reg_mask"],
                               x["residuals"], x["T"], seg_points_sensor=x["raw"])
        st, out = tracker.update(cfg.tracking, tracks, det.objects, x["dt"])
        return interop.state_to_numpy(det), interop.state_to_numpy(st), interop.state_to_numpy(out)

    (dg, sg, og), (dc, sc, oc) = run("cuda"), run("cpu")
    flips = float(np.mean(dg.labels != dc.labels))
    slot_flips = float(np.mean(dg.pixel_slot != dc.pixel_slot))
    box_err = float(np.abs(dg.objects.state - dc.objects.state).max())
    float_err = max(
        float(np.abs(a - b).max()) for a, b in zip(sg, sc) if a.dtype.kind == "f"
    )
    rec = dict(
        label_mismatch_share=flips, pixel_slot_mismatch_share=slot_flips,
        valid_slots=int(dg.objects.valid.sum()), box_state_max_abs=box_err,
        tracker_float_max_abs=float_err,
    )
    print("detection gpu-vs-cpu " + json.dumps(rec), flush=True)
    check(flips == 0.0, f"labels differ on {flips:.2e} of the pixels")
    check(slot_flips == 0.0, f"pixel_slot differs on {slot_flips:.2e} of the pixels")
    check(np.array_equal(dg.objects.valid, dc.objects.valid), "valid slots differ")
    check(box_err <= STATE_ATOL, f"box states differ by {box_err}")
    for name, a, b in zip(sg._fields, sg, sc):
        if a.dtype.kind == "f":
            check(np.allclose(a, b, atol=STATE_ATOL, rtol=STATE_ATOL), f"tracker {name} differs")
        else:
            check(np.array_equal(a, b), f"tracker {name} differs")
    for name, a, b in zip(og._fields, og, oc):
        if a.dtype.kind != "f":
            check(np.array_equal(a, b), f"tracker output {name} differs")
    return rec


def slice_summary(tag, poses, steps, ref, seq, n, card):
    from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics

    div = np.linalg.norm(poses[:, :3, 3] - ref["poses"][:n, :3, 3], axis=1)
    ms = [r["ms"] for r in steps[WARMUP_SCANS:]]
    med = statistics.median(ms)
    out = dict(
        scans=n, card=card, max_divergence_mm=float(div.max()) * 1e3,
        ate_port_mm=metrics.ate_rmse(poses[:, :3, 3], seq.gt_poses[:n]) * 1e3,
        ate_jax_cpu_mm=float(ref["ate"]) * 1e3,
        keyframes=steps[-1]["num_keyframes"],
        keyframe_flags_match_jax=[r["keyframe_added"] for r in steps]
        == ref["keyframe_added"][: n - 1].tolist(),
        s2s_iterations=[r["s2s_iterations"] for r in steps],
        s2m_iterations=[r["s2m_iterations"] for r in steps],
        step_ms=ms, median_ms=med, hz=1e3 / med,
    )
    check(all(r["s2m_converged"] for r in steps), f"{tag}: an S2M registration did not converge")
    check(bool(np.all(np.isfinite(poses))) and poses.shape == (n, 4, 4), f"{tag}: poses not finite")
    return out, float(div.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke check of the PyTorch port on one GPU")
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                    help="comma-separated subset; the check is the full run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    full = phases == set(range(1, 9))

    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import dynamic_direct_lidar_odometry_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from dynamic_direct_lidar_odometry_tpu_torch import config
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, nn_cuda, segmentation
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

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
    print(f"build: {len(built)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, b in built.items():
        print(f"build {name}: {b.path.name} (nvcc {b.seconds:.2f} s)", flush=True)
        if b.log:
            print(b.log.strip(), flush=True)

    ref_dlo, ref_ddlo = np.load(GOLDEN_DLO), np.load(GOLDEN_DDLO)
    n = int(ref_ddlo["n_scans"])
    check(int(ref_dlo["n_scans"]) == n, "the two goldens cover different scans")
    cfg_dlo = config.bench_config(dynamic_detection=False)
    cfg = config.bench_config()
    seq = None
    if phases & {3, 4, 5, 6, 7, 8}:
        t0 = time.perf_counter()
        seq = sequence.steady_state_sequence(64)
        print(f"sequence: 64 scans {seq.H}x{seq.W} in {time.perf_counter() - t0:.1f} s (host)", flush=True)
        digest = sequence.sequence_sha256(seq, n)
        for ref in (ref_dlo, ref_ddlo):
            check(digest == str(ref["scans_sha256"]),
                  f"scans 0-{n - 1} differ from the reference sequence (sha256 {digest})")

    # ---- 3. kernels vs their plain versions ----
    records = {}
    if 3 in phases:
        query, s2s_t, s2m_t, odd_q, odd_t = kernel_inputs(cfg_dlo, seq, ref_dlo["poses"], dev)
        s2m_r = cfg.gicp.s2m.max_correspondence_distance
        s2s_r = cfg.gicp.s2s.max_correspondence_distance
        k = cfg.gicp.s2s.k_correspondences
        recs = [
            check_sparse("s2m", query, s2m_t, s2m_r),
            check_sparse("s2m_residual", query, s2m_t, 3.0 * s2m_r),
            check_sparse("s2s", query, s2s_t, s2s_r),
            check_sparse("sentinels_nonmultiple", odd_q, odd_t, s2m_r),
            check_dense("s2m_16k_x_64k", query, s2m_t),
            check_dense("s2s_16k_x_16k", query, s2s_t),
            check_dense("sentinels_nonmultiple", odd_q, odd_t),
            check_classes(f"cov_k{k}", query, query, k),
            check_classes("cov_k20", query, query, 20),
            check_classes("sentinels_nonmultiple", odd_q, odd_q[: odd_q.shape[0] - 100], k),
            check_classes(f"cov_k{k}_r5", query, query, k, prune_radius=5.0),
            check_classes("sentinels_nonmultiple_r5", odd_q, odd_q[: odd_q.shape[0] - 100], k,
                          prune_radius=5.0),
        ]
        for r in recs:
            records.setdefault(r["kernel"], []).append(r)

    launches = {}
    if 4 in phases:
        # ---- 4. plain DLO ----
        nn_cuda.LAUNCHES.clear()
        poses, steps = run_slice(cfg_dlo, seq.points[:n], seq.mask[:n], seq.stamps[:n], dev, timed=True)
        got = dict(nn_cuda.LAUNCHES)
        linz = sum(r["s2s_iterations"] + r["s2m_iterations"] + 1 for r in steps)
        summary, div = slice_summary("plain DLO", poses, steps, ref_dlo, seq, n, card)
        print("slice " + json.dumps(dict(summary, launches=got, linearizations=linz)), flush=True)
        check(got.get("nn1_sparse", 0) >= linz > 0, f"nn1_sparse launched {got} for {linz} linearizations")
        check(div <= DIVERGENCE_BAR_M, f"plain DLO poses diverge {div * 1e3:.3f} mm from JAX")

    keep = n // 2
    inputs = None
    if phases & {5, 6}:
        # ---- 5. full DDLO, default backends ----
        nn_cuda.LAUNCHES.clear()
        segmentation.SWEEPS.clear()
        hungarian.HOST_READS.clear()
        poses, steps = run_slice(cfg, seq.points[:n], seq.mask[:n], seq.stamps[:n], dev,
                                 timed=True, keep=keep)
        launches["nn1_sparse"] = nn_cuda.LAUNCHES["nn1_sparse"]
        linz = sum(r["s2s_iterations"] + r["s2m_iterations"] + 1 for r in steps)
        inputs = steps[keep - 1].pop("inputs")
        summary, div = slice_summary("DDLO", poses, steps, ref_ddlo, seq, n, card)
        dets = [r["detections"] for r in steps]
        jax_dets = ref_ddlo["detections"].tolist()
        summary.update(
            launches=dict(nn_cuda.LAUNCHES), linearizations=linz,
            detections=dets, detections_jax=jax_dets,
            track_status=[r["status"] for r in steps],
            track_status_jax=ref_ddlo["track_status"].tolist(),
            ccl_sweeps=segmentation.SWEEPS["sweeps"],
            ccl_host_reads=segmentation.SWEEPS["host_reads"],
            jv_host_reads=dict(hungarian.HOST_READS),
        )
        print("ddlo " + json.dumps(summary), flush=True)
        check(summary["keyframe_flags_match_jax"], "DDLO keyframe flags differ from JAX")
        check(launches["nn1_sparse"] >= linz > 0, f"nn1_sparse launched {launches['nn1_sparse']} for {linz}")
        check(div <= DIVERGENCE_BAR_M, f"DDLO poses diverge {div * 1e3:.3f} mm from JAX")
        check(abs(sum(dets) - sum(jax_dets)) <= DETECTION_BAR * sum(jax_dets),
              f"{sum(dets)} valid detections against {sum(jax_dets)} in the JAX run")

    if 6 in phases:
        # ---- 6. detection + tracking, card vs host ----
        compare_detection(inputs, cfg)

    if 7 in phases:
        # ---- 7. full DDLO, dense backends ----
        with env(DDLO_NN_IMPL="pallas", DDLO_KNN_IMPL="pallas"):
            nn_cuda.LAUNCHES.clear()
            m = DENSE_SCANS
            poses, steps = run_slice(cfg, seq.points[:m], seq.mask[:m], seq.stamps[:m], dev, timed=True)
            got = dict(nn_cuda.LAUNCHES)
        linz = sum(r["s2s_iterations"] + r["s2m_iterations"] + 1 for r in steps)
        cov_calls = 2 + len(steps) + sum(r["keyframe_added"] for r in steps)
        summary, div = slice_summary("dense DDLO", poses, steps, ref_ddlo, seq, m, card)
        print("ddlo_dense " + json.dumps(dict(summary, launches=got, linearizations=linz,
                                              covariance_calls=cov_calls)), flush=True)
        launches["nn1_dense"] = got.get("nn1_dense", 0)
        launches["knn_classes"] = got.get("knn_classes", 0)
        check(launches["nn1_dense"] >= linz > 0, f"nn1_dense launched {got} for {linz} linearizations")
        check(launches["knn_classes"] >= cov_calls, f"knn_classes launched {got} for {cov_calls} covariance calls")
        check(got.get("nn1_sparse", 0) == 0, "nn1_sparse launched with the dense backends")
        check(div <= DIVERGENCE_BAR_M, f"dense DDLO poses diverge {div * 1e3:.3f} mm from JAX")

    if 8 in phases:
        # ---- 8. the pruned k-NN entry point ----
        nn_cuda.LAUNCHES.clear()
        k = cfg.gicp.s2s.k_correspondences
        for i in range(DENSE_SCANS):
            p = preprocess.preprocess(cfg, torch.as_tensor(seq.points[i], device=dev),
                                      torch.as_tensor(seq.mask[i], device=dev))
            idx, d = nn_cuda.knn_approx(p.points, p.points, k, prune_radius=5.0)
            check(bool((d[p.mask, 0] == 0).all()),
                  "pruned k-NN: a real point is not its own nearest neighbor")
            check(bool(torch.isfinite(d).all()), "pruned k-NN: distances not finite")
        launches["knn_classes_sparse"] = nn_cuda.LAUNCHES["knn_classes_sparse"]
        print(f"pruned knn: {launches['knn_classes_sparse']} launches over {DENSE_SCANS} scans", flush=True)
        check(launches["knn_classes_sparse"] == DENSE_SCANS, "pruned k-NN did not launch per call")

    if not full:
        print(f"chip_smoke: phases {sorted(phases)} passed (partial run, no result)")
        return 0

    kernels = []
    for name, meta in KERNELS.items():
        recs = records[name]
        main_case = recs[0]
        kernels.append(dict(
            name=name, route="cuda", **meta, launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=None, cdist_ms=main_case["cdist_ms"], case=main_case["case"],
        ))
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
