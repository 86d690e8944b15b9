#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (the check)
    python3 chip_smoke.py --phases 1,2,3  # a subset, e.g. after a kernel edit
    python3 chip_smoke.py --accuracy-out ACCURACY_torch.json  # also write phase 16's report

Phases, in order; any failure exits non-zero and prints no result:

1. Device: a CUDA card is required; prints its name and power limit
   (``nvidia-smi``) and checks that TF32 is off.
2. Build: compiles ``csrc/nn1_sparse.cu``, ``csrc/knn_classes.cu``,
   ``csrc/jv_solve.cu``, ``csrc/plane_reg.cu``, ``csrc/graph_cond.cu``,
   ``csrc/lm_trial.cu`` and ``csrc/trace.cu`` with nvcc for sm_90a, one
   nvcc each, all started together.
3. Every kernel against its plain PyTorch version, on the card, at the
   main paths' shapes, with inputs built from the benchmark sequence:
   sparse 1-NN (S2M 16,384 x 65,536 at r = 2 and 6, S2S 16,384 x 16,384
   at r = 1), dense 1-NN (16,384 x 16,384 and 16,384 x 65,536), lane-class
   k-NN (16,384 x 16,384 at k = 10 and 20, dense and pruned at r = 5),
   plus sentinel / non-multiple cases, a tie case (every target point
   four times, the copies straddling the 1-NN kernels' split boundaries
   and, for the lane-class kernel, meeting inside a class and across
   classes) and a long-list case (one query tile whose box spans the
   submap); for the lane-class kernel also k = 1 and k = 128, a target
   of exactly one chunk, 128-row chunks whose count is no multiple of
   the kernel's batch, and a pruned call with one tile's list emptied.
   Pass: identical index and distance on every row, in radius or not;
   no kernel spills registers; a lane-class call is two device operations
   (the kernel and the add of its device count).
   Times (median of 20 calls): ``ms``, the device time of every operation
   one wrapper call puts on the card (``torch.profiler``: the 1-NN key
   fill and kernel, summed per call); ``kernel_ms``, the kernel's alone;
   ``call_ms``, the wrapper call between CUDA events (host time
   included); the plain version's (CUDA events). Also printed: each
   kernel's ptxas registers and spills, and the device operations one
   1-NN call costs (``torch.profiler``).
   The two kernels without a Pallas counterpart: ``jv_solve``
   (``hungarian.solve``) against ``solve_plain`` on the card at N = 32, 64,
   128 and 256 (uniform costs, integer ties, BIG rows and columns, all BIG,
   NaN costs; all, half, a quarter or no rows valid; N = 256 is the
   kernel's instance that reads rows from device memory; at N = 33 and 64
   also a cost stored off a 16-byte boundary), and after phase 5 on every
   tracker cost matrix that phase solved (timed on the one with the most
   path steps; N = 64, 128 and 256 timed beside it); pass: identical
   ``col_of_row``. ``regularize_plane``
   against ``regularize_plane_plain`` on the card and on the host, on the
   bench scan's window covariances, collinear, denormal-sized and FMA-tie
   rows; pass: every finite row bit-equal, one launch per call. The
   window path whole, ``window_plane_cov`` (``csrc/plane_reg.cu``
   ``ddlo_window_plane_cov``), against ``window_plane_covariances_plain``
   on the card: the bench scan (16,384 rows) at k = 10 and 20, a keyframe
   cloud of 8,192, the CLI's 65,536, 15,607 rows (no multiple of 128), a
   whole block of sentinels and a cloud whose k-th and (k+1)-th distances
   tie; pass: every row bit-equal, one launch and two device operations
   (the kernel and its count add) per call; ``torch.topk`` of the same
   distances timed beside it. Each prints device ms, call ms, plain ms
   and its bound. The segment gates and slots, ``segment_objects``
   (``csrc/segment_objects.cu`` ``ddlo_segment_objects``), against
   ``segment_objects_plain`` on the card: on ``tests/torch_segment_cases.py``'s
   cases (the CPU tests' inputs) and, after phase 5, on every
   ``segment_objects`` call of that phase's eager run (the bench scans,
   timed on the first, with the plain version and the launches one call
   puts on the card); pass: every output bit-equal (slot roots,
   ``slot_valid``, ``pixel_slot``, the slot means as bits, ``seg_roots``),
   one launch per call. The capture
   driver's ``set_cond`` (``csrc/graph_cond.cu``): a nested WHILE loop and
   an IF/ELSE branch captured into a graph and replayed on four inputs
   (0 to 27 inner turns), each replay without any synchronization,
   against the eager driver (``core/control.read_predicate``); the
   kernel's own test (``control.Test``) against its plain evaluation on
   ``tests/torch_cond_cases.py``'s grid (each output byte), an IF / ELSE
   pair on a test set by one launch, and CCL's 131,072-entry != test run
   twice in a row on one scratch; pass: the same turn counts, values and
   decisions, one launch per pair, the scratch left zeroed. GICP's lambda loop
   (``csrc/lm_trial.cu``): ``gicp.lm_inner`` (the whole loop, one
   cluster of 8 blocks per stream) against ``lm_inner_plain`` on
   ``tests/torch_lm_cases.py``'s GICP-like streams at B = 1 and 8: the
   shared-memory route at 16,384 points, 17,000 (no multiple of the
   4,096 partials) and 1,001 (streams off a 16-byte boundary), the
   device-memory route at 65,536 (the CLI cloud), batches holding a free
   loop, a far start, a loop rejected until lm_max_iterations, a step
   d = 0, a degenerate stream and one that does not run, and
   lm_max_iterations 3 and 0; after phase 5, on every lambda loop that
   phase's eager run made (its inputs recorded), its last 8 loops
   stacked (B = 8) and its last loop four times over at 65,536 points
   (B = 1 and 8; device memory). The split trial: ``gicp.lm_propose``
   against ``lm_propose_plain`` on the systems (SPD, near-singular, a
   guarded pivot, the small-angle branch, d = 0, GN's zeroed streams;
   B = 1 and 8) and on a dense sweep of half-angles (2^20 streams through
   ``sinf`` / ``cosf``), ``gicp.lm_decide`` against ``lm_decide_plain``
   on its scenarios (accept, grow, converge on a reject, the 0/0 guard,
   frozen streams) and on rejected trials whose convergence test steps
   through its bar an ulp at a time; after phase 5, both on the first
   trial of every loop of that phase's eager run; pass: every output
   bit-equal on every stream, one launch per call. Each prints device
   ms, call ms, plain ms, its bound (``lm_inner``: the points' bytes
   read once and the trials' operations) and the launch floor (a
   one-element add's device time); ``lm_inner`` its route, trials and
   the shared-memory route's largest N. The span stamp
   (``csrc/trace.cu``, ``profiling.mark``): the bench step's graph
   replayed twice inside ``device_counts`` against the same scans stepped
   on the CPU (the host clock); pass: every span's ``.n`` and the count
   of stamps equal, the stage spans within the graph's, a replay with
   tracing off changing no span count or open time, every timed stamp
   counted.
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
   JAX total; one ``jv_solve`` launch per ``tracker.update`` and no host
   read of the JV solve (``hungarian.HOST_READS``), one covariance kernel
   per ``plane_covariances`` call, ``window_plane_cov`` (the window path)
   or ``regularize_plane`` (the exact path), and on the bench
   configuration's window path no ``regularize_plane`` (the same launch
   checks in phases 6, 9, 11, 15 and 16; phase 16's exact legs no
   ``window_plane_cov``); one ``segment_objects`` launch per
   ``tracker.update`` (phases 5, 6, 9, 11, 14 and 17); on the graph run and on
   the eager one, one ``lm_inner`` launch per lambda loop (the eager
   run's ``gicp.TORCH.lm_inner`` calls), no ``lm_propose`` or
   ``lm_decide`` launch and no error re-evaluation, and no eager
   ``solve6_ldlt``, ``se3_exp`` or plain version in any loop.
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
9. The replay loop: ``runner.replay(bench_config(), ...)`` on the card
   over the same 16 scans, into a temporary directory with every artifact
   on (evaluation dumps, ``checkpoint_every=8``, ``save_every=8``,
   ``export_clouds_every=8``). Pass: poses within 10 mm of the JAX CPU
   replay (``tests/golden/torch_port_replay_steady_jaxcpu.npz``),
   keyframe count equal, map points within 2 %, dynamic pixels within
   10 %; every artifact exists and parses, ``map.pcd`` holds the final
   snapshot's points; resuming from ``ckpt_000008.npz`` reproduces scans
   9-15 within 1e-5 m; ``mapper.remove_boxes`` on the card equals the
   port on the host for the final map and every history box of the final
   tracks. Times: the ``total`` accumulator per scan of a second replay
   without artifacts (and of the first), the map node's calls at their
   replay inputs, and the device idle share (busy time from a profiled
   third replay over the second's wall time).
10. The CLI at its own capacity: the first 8 scans written to an ``.npz``
   and ``cli.main(["run", "--dataset", ..., "--out", ..., "--quiet"])``
   (``doals_config`` + ``capacity_for_scan``: 128 keyframes, a 65,536-point
   cloud, a 262,144-point submap). Pass: the TUM trajectory within 10 mm
   of the JAX CPU run (``tests/golden/torch_port_cli_steady_jaxcpu.npz``),
   keyframe count equal, ATE < 5 cm; the blocked (K > 64) hulls ran; the
   card's blocked hull masks equal the host port's for the final store
   (from the run's last checkpoint) and for 128- and 256-keyframe stores,
   which are also timed. A second run without artifacts gives the
   per-scan ``total`` and, with a profiled third, the idle share.
11. The fork's kantplatz configuration at its published 512 x 512
   (``kantplatz_config()``, the segmentation window 156..356, the camera
   residual grid) with the CLI's capacity for such a dataset
   (``capacity_for_scan(512, 512)``: 65,536 / 262,144 / K = 128 / 32
   objects) over ``utils.sequence.kantplatz_sequence()`` (6 scans, checked
   against the golden's checksum). Pass: poses within 10 mm of the JAX CPU
   run (``tests/golden/torch_port_kantplatz512_jaxcpu.npz``), keyframe
   flags equal, every S2M converged, no label outside the window, every
   scan's labels equal to the camera grid's plain reference
   (``cardbench/reference/components.py``; the port departs from JAX's
   labels there) but in components that touch an edge whose angle lies
   within one float32 ulp of theta. Times: per-scan latency (CUDA
   events, median after 2 warm-up scans), device busy ms and idle share.
12. ``pipeline.step_chunk`` with K = 8 over ``bench_config()`` scans 1-8
   against 8 ``pipeline.step`` calls on the card from the same state.
   Pass: poses within 1e-6 m, keyframe flags and the store count equal.
13. ``parallel.sharding.batched_align``: B = 8 S2M registrations at full
   width (16,384 x 65,536: the sources, targets and guesses of phase 5's
   last 8 S2M calls, recorded there; guess b moved by (0.03 (b + 1),
   -0.02 b, 0) m and turned by 0.005 b rad, so every stream starts off
   its optimum by its own amount). On the card the aligner replays a
   captured graph of ``gicp.align_batch`` (its loops conditional nodes).
   Pass: the replay bit-equal to the eager ``gicp.align_batch`` in every
   field, under ``torch.cuda.set_sync_debug_mode("error")``; against 8
   single-stream ``gicp.align`` calls iterations and inliers equal,
   translation within 1e-5 m, rotation within 1e-6; the replay's device
   counts exactly one ``nn1_sparse_batched`` launch per batched
   linearization and no ``nn1_sparse`` launch, one ``lm_inner`` per
   lambda loop of the eager call and no split trial. Times (CUDA events, after
   capture): registrations/s at B = 1 and B = 8, graph and eager in
   turns, each graph's capture seconds and pool bytes, and the batched
   entry's device ms at the final poses against its bound.
14. ``parallel.replay.replay_batch``: B = 4 streams x 8 scans of
   ``bench_config()``, started at scans 0, 8, 16 and 24, and the batched
   step under it (``sharding.batched_pipeline_step``: one graph per call,
   each stream a branch of it). Pass: each stream's state and outputs
   bit-equal to that stream run alone through ``pipeline.step``'s graph,
   every leaf after every scan, and ``replay_batch``'s poses and final states those of the
   batched step; every replay under ``set_sync_debug_mode("error")``; one
   ``cudaGraphLaunch`` per B-stream step (profiler); exact device counts:
   one ``jv_solve`` per tracker update, one tracker update and at least
   three ``nn1_sparse`` per stream scan. Times: ms per stream scan at
   B = 1, 4 and 8 (B = 8: streams started at 0, 8, ..., 56, scans 1-4),
   beside the single graph step and the streams in turn through
   ``step_eager`` (the host-driven form of the batched step), in turns; device busy
   ms and idle share at B = 4 (a profiled step against the unprofiled
   wall); each batched graph's capture seconds and pool bytes.
15. Point-parallel on 2 ranks: two spawned processes, a gloo group on the
   one card (NCCL refuses two ranks on one device), each under a time
   limit. (a) ``sharding.batched_align(point_sharded=True)`` of phase
   13's 8 problems (each rank 8,192 of the 16,384 source rows against the
   whole 65,536-row target, the sums gathered and added in rank order
   inside every LM iteration) against phase 13's 8 single aligns. Pass:
   iterations and inliers equal, translation within 1e-5 m, rotation
   within 1e-6, both ranks' results bit-equal, one ``nn1_sparse_batched``
   launch per batched linearization on each rank. (b)
   ``sharding.point_parallel_pipeline_step`` over ``bench_config()``
   scans 1-8 from ``init_state`` on scan 0. Pass: poses within 10 mm of
   the JAX CPU golden, keyframe flags equal, every S2M converged, the two
   ranks' states and outputs bit-equal after every scan, residuals
   gathered to full length, and on each rank ``nn1_sparse`` launched for
   every linearization and ``knn_classes`` for the shard's covariances
   (8,192 queries against the whole scan), and the split trial on every
   rank (``lm_propose`` and ``lm_decide`` once per trial, no
   ``lm_inner``: the error is summed over the ranks between the two);
   the step itself raises if an
   op has no deterministic implementation or the ranks' states differ
   (``distributed.check_agree``). Times (CUDA events, each rank): ms per
   scan and per registration, and the agreement check alone; two ranks
   share one card, so they say nothing of multi-card scaling.

16. The accuracy tool (``tools/torch_accuracy.py``): its four card legs,
   ``runner.replay(bench_config(), ...)`` over all 64 scans of phase 4's
   sequence (checked against both accuracy goldens' checksums):
   ``gpu_default``, ``gpu_exact`` (``DDLO_NN_IMPL=exact``,
   ``DDLO_KNN_IMPL=exact``), ``gpu_exact_hulls`` (host hulls) and
   ``gpu_laneclass`` (``DDLO_KNN_IMPL=pallas``). Pass: the JAX tool's bars
   (default vs exact and device vs exact hulls < 10 mm stamp-aligned RMSE,
   every leg < 5 cm ATE), ``gpu_default`` within 10 mm (max divergence) of
   the JAX CPU run with window covariances
   (``tests/golden/torch_port_accuracy64_jaxcpu_window.npz``) and
   ``gpu_exact`` of the exact one (``..._jaxcpu_exact.npz``), the lane-class
   leg held to the same bars against ``gpu_exact`` and the exact golden;
   each leg's launches show its path (``nn1_sparse`` for every
   linearization and residual pass, ``knn_classes`` for every covariance
   call of the lane-class leg and never elsewhere, no kernel in
   ``gpu_exact``). The report is one ``accuracy`` JSON line
   (``--accuracy-out`` also writes it to a file).

17. The step and the chunk as captured graphs: ``pipeline.step`` (a
   graph replay) against ``pipeline.step_eager`` over ``bench_config()``
   scans 1-16. Pass: every leaf of every state and output bit-equal
   (NaN = NaN; poses, keyframe flags, detections and track states gate
   the phase); every replay after the capture under
   ``torch.cuda.set_sync_debug_mode("error")``; one ``cudaGraphLaunch``
   per step (profiler) with ``nn1_sparse`` (3 a scan), ``jv_solve``,
   ``window_plane_cov`` (and no ``regularize_plane``), ``set_cond`` and
   ``lm_inner`` running inside it
   (and no split trial), on the device counts and, in a process that has
   captured no other graph (this check runs right after phase 2), by
   the profiler's names: once phases 4-12 have run in the process, the
   profiler names kernels inside conditional bodies wrongly, and the
   phase prints which names differ from that early check's;
   ``step_chunk`` (K = 8) one graph launch, bit-equal to the graph steps;
   the runner's watchdog on the graph path (a poisoned pose rolls back to
   a state no later replay overwrote: the run equals a replay without
   that scan). Prints per-scan wall of both steps (eager, graph, graph,
   eager), device busy ms and idle share, device kernels and host launch
   calls per scan, ``set_cond`` per scan and its device µs, each graph's
   capture seconds and memory, the chunk's ms per scan.

Phases 4-17 run the graph step (``pipeline.step`` on the card). A
replay launches kernels without calling their wrappers, whose counts
(``nn_cuda.LAUNCHES``) advance at capture, so those phases' launch
checks count on the device (``main_path_counts``:
``utils.profiling.device_counts``, the counts that
``nn_cuda.run_kernel``, ``tracker.update``,
``covariance.plane_covariances`` and ``segmentation.label_components``
add on the device, in the graph users run; a graph's eager warm-up is
not counted, only its replays). Phase 5 records the S2M
problems of phases 13 and 15, and the tracker's cost matrices of phase
3, from an eager run of its scans (a replay calls no Python).

Each phase prints the wall time at which it starts (``at T s: phase N``)
and a full run its total (``wall: T s``).

Phase 3 also holds the lane-class kernel with half the queries (each
half of the 16,384-row cloud against all of it, as phase 15's ranks call
it), the batched sparse entry (``nn1_sparse_batched``, 8 stacked S2M
problems: the submap, its ties, its long list and its sentinels) to its
plain version and to 8 single calls, every row.

The line before the last is the kernel table as JSON (``nn1_sparse``'s
launches summed over phases 4, 5, 9, 10, 11, 12, 14, 15 and 16;
``nn1_sparse_batched``'s from phases 13 and 15; ``knn_classes``' from
phases 7, 15 and 16, phase 15's summed over both ranks; ``jv_solve``'s,
``regularize_plane``'s and ``window_plane_cov``'s from phases 5, 6, 9,
11, 15 and 16; ``set_cond``'s
from phase 17's graph run; ``lm_inner``'s from every phase that counts
with ``main_path_counts`` and phase 13; ``segment_objects``' from every
phase that counts with ``main_path_counts``; ``lm_propose``'s and
``lm_decide``'s from those and phase 15's ranks); the last line
is ``{"ok": true, "device": {...}}`` (full runs only).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DLO = os.path.join(ROOT, "tests", "golden", "torch_port_dlo_steady_jaxcpu.npz")
GOLDEN_DDLO = os.path.join(ROOT, "tests", "golden", "torch_port_ddlo_steady_jaxcpu.npz")
GOLDEN_REPLAY = os.path.join(ROOT, "tests", "golden", "torch_port_replay_steady_jaxcpu.npz")
GOLDEN_CLI = os.path.join(ROOT, "tests", "golden", "torch_port_cli_steady_jaxcpu.npz")
GOLDEN_KANTPLATZ = os.path.join(ROOT, "tests", "golden", "torch_port_kantplatz512_jaxcpu.npz")
DIVERGENCE_BAR_M = 0.010  # the ACCURACY_r05.json default-vs-exact bar
DETECTION_BAR = 0.10  # total valid detections vs the JAX CPU run
MAP_BAR = 0.02  # map points vs the JAX CPU replay
DYNAMIC_BAR = 0.10  # dynamic pixels over the run vs the JAX CPU replay
ATE_BAR_M = 0.05  # BASELINE.md's 5 cm
RESUME_ATOL_M = 1e-5
CHUNK_ATOL_M = 1e-6  # step_chunk against the same steps, one by one
BATCH_T_ATOL_M, BATCH_R_ATOL = 1e-5, 1e-6  # batched_align against single aligns
CHUNK_K, ALIGN_B, STREAMS, STREAM_SCANS = 8, 8, 4, 8
GRAPH_SCANS, WATCHDOG_SCANS = 16, 7  # phase 17: graph vs eager steps; the watchdog's replay
PT, PT_SCANS, PT_TIMEOUT_S = 2, 8, 480  # phase 15: ranks on the one card, scans, each rank's limit
WARMUP_SCANS = 2
DENSE_SCANS = 8
SPAN_SCANS = 4  # phase 3's stamp case: init, the capture's step, two traced replays
# a stamp's bytes: the gate (1), its own count (read, write), the closed
# span's open time (read, write), ns and n (read, write each), the new open time
SPAN_BYTES = 1 + 16 + 16 + 32 + 8
STATE_ATOL = 1e-4
PKG = "dynamic_direct_lidar_odometry_tpu_torch"
KERNELS = {
    "nn1_sparse": dict(source=f"{PKG}/csrc/nn1_sparse.cu",
                       replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:181"),
    "nn1_dense": dict(source=f"{PKG}/csrc/nn1_sparse.cu",
                      replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:89"),
    "nn1_sparse_batched": dict(source=f"{PKG}/csrc/nn1_sparse.cu",
                               replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:181"),
    "knn_classes": dict(source=f"{PKG}/csrc/knn_classes.cu",
                        replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:339"),
    "knn_classes_sparse": dict(source=f"{PKG}/csrc/knn_classes.cu",
                               replaces="dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:356"),
    # no Pallas kernel: the JAX package leaves these two to XLA
    "jv_solve": dict(source=f"{PKG}/csrc/jv_solve.cu",
                     replaces="dynamic_direct_lidar_odometry_tpu/ops/hungarian.py:23"),
    "regularize_plane": dict(source=f"{PKG}/csrc/plane_reg.cu",
                             replaces="dynamic_direct_lidar_odometry_tpu/ops/covariance.py:213"),
    # the window path whole: _window_self_covariances, regularize_plane, the mask
    "window_plane_cov": dict(source=f"{PKG}/csrc/plane_reg.cu",
                             replaces="dynamic_direct_lidar_odometry_tpu/ops/covariance.py:89"),
    # the capture driver's helper: the device-side test of a loop or branch
    # (the JAX package's lax.while_loop / lax.cond, e.g. the LM loop)
    "set_cond": dict(source=f"{PKG}/csrc/graph_cond.cu",
                     replaces="dynamic_direct_lidar_odometry_tpu/ops/gicp.py:409"),
    # no Pallas kernel: XLA fuses the LM loop's scalar math and its error
    "lm_inner": dict(source=f"{PKG}/csrc/lm_trial.cu",
                     replaces="dynamic_direct_lidar_odometry_tpu/ops/gicp.py:350"),
    "lm_propose": dict(source=f"{PKG}/csrc/lm_trial.cu",
                       replaces="dynamic_direct_lidar_odometry_tpu/ops/gicp.py:361"),
    "lm_decide": dict(source=f"{PKG}/csrc/lm_trial.cu",
                      replaces="dynamic_direct_lidar_odometry_tpu/ops/gicp.py:359"),
    # the stage timer on the device: the JAX package times stages on the host
    "span": dict(source=f"{PKG}/csrc/trace.cu",
                 replaces="dynamic_direct_lidar_odometry_tpu/utils/profiling.py:104"),
    # no Pallas kernel: the JAX package leaves the segment gates to XLA
    "segment_objects": dict(source=f"{PKG}/csrc/segment_objects.cu",
                            replaces="dynamic_direct_lidar_odometry_tpu/ops/segmentation.py:360"),
}
# the bound: FP32 work at the H100 SXM's non-tensor issue rate (67 TFLOP/s
# counts an FMA as 2; the function rounds every operation, so none fuses:
# --fmad=false), against each input read once and each output written
# once at 3.35 TB/s
FP32_ISSUE_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# 3 sub, 3 mul, 2 add per pair on the FP32 pipe; the minimum (compare,
# select) runs on the ALU pipe beside it and is not counted
OPS_PER_PAIR = 8
# FP64 at the H100 SXM's non-tensor rate (34 TFLOP/s, NVIDIA's data sheet,
# an FMA counted as 2)
FP64_ISSUE_PER_S = 34e12 / 2
# IEEE operations per matrix in csrc/plane_reg.cu, counted from the code
# (a division or root as one; the flush, the selections and the f32/f64
# conversions are not counted; atanf's argument reduction at its longest,
# four): f32 add/sub/mul/fma/div/sqrt (three roots and four quotients
# among them); f64 add/mul (cosf's range reduction and polynomials)
PLANE_F32_OPS, PLANE_F64_OPS = 123, 27
# f32 operations per stream in csrc/lm_trial.cu, counted from the code
# (a division, root or sign flip as one, the selections not counted):
# the solve 213 (LDLT 141, substitutions 66, the negated b 6), se3_exp 52
# and sinf / cosf about 20 each on their fast path; the decision 67 (the
# denominator 23, rho 2, the convergence test 33, lambda and nu 9)
LM_PROPOSE_F32_OPS, LM_DECIDE_F32_OPS = 305, 67
# lm_inner: per point and evaluation of the error 45 (the transform 18,
# e 6, M e 15, e . Me 5, the running sum 1); per trial the proposal, the
# compose (16 entries of 4 products and 3 sums) and the decision
LM_POINT_F32_OPS, LM_TRIAL_F32_OPS = 45, LM_PROPOSE_F32_OPS + 112 + LM_DECIDE_F32_OPS
# segment_objects' bytes a pixel: its label, range and residual (4 each)
# and point (12) read once, its slot (4) written once
SEGMENT_BYTES_PER_PIXEL = 28


def lm_propose_bytes(streams: int, zero: bool) -> int:
    """Bytes ``ddlo_lm_propose`` moves: per stream it reads H's lower
    triangle (21 floats: the solve touches no other entry), b and lam
    (and the 1-byte zero flag when there is one), and writes d and
    delta."""
    return streams * (4 * (21 + 6 + 1) + int(zero) + 4 * (6 + 16))


def lm_decide_bytes(streams: int, accepted: int, ended: int) -> int:
    """Bytes ``ddlo_lm_decide`` moves: per stream it reads y0, yi, lam,
    nu, d, b, delta's 3 x 4 top (the convergence test) and the four
    1-byte flags, and writes lam, nu and the flags; j is read and written
    once. ``accepted`` streams also read xi and write x; ``ended`` ones
    (accepted or converged on a reject) read delta's last row and write
    delta_done."""
    per = 4 * (4 + 6 + 6 + 12) + 4 + 4 * 2 + 4
    return streams * per + 8 + accepted * 4 * (16 + 16) + ended * 4 * (4 + 16)


def lm_inner_bytes(N: int, active: int, streams: int) -> int:
    """Bytes ``ddlo_lm_inner`` moves: each stream that runs trials reads
    its N points once (source 12, M 36, B 12, validity 1 bytes a point),
    H's lower triangle, b, lam and x0; every stream reads its two flags
    and writes lam, nu, x, delta_done, its four flags and its count."""
    return active * (61 * N + 4 * (21 + 6 + 1 + 16)) + streams * (2 + 4 * (2 + 16 + 16) + 4 + 4)


# the kernels every covariance call and tracker update launch on the card,
# counted per phase (phases 5, 6, 9, 11, 15 and 16)
CARD_KERNELS = ("jv_solve", "regularize_plane", "window_plane_cov")
# launches of the lambda loop's kernels on the main path, by kernel, summed
# over every block that main_path_counts (and phases 13 and 15) counted
PATH_LAUNCHES = collections.Counter()


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


def device_times(fn, kernel: str, reps: int = 20) -> dict:
    """What ``reps`` calls of ``fn`` put on the card, from one
    ``torch.profiler`` session (CUPTI's timestamps: the host's time
    between launches is not counted). A call is the kernel whose name
    contains ``kernel`` and the operations since the previous one (a
    1-NN call's key fill); the profiler may miss the session's first
    operation, so medians are taken. ``ms``: the median per-call sum;
    ``kernel_ms``: the kernel's median; ``device_ops_per_call``: the most
    operations in a call. None values when the profiler shows no such
    kernel (tried three times)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        calls, kern, pending = [], [], []
        for a, b, name in ev:
            pending.append((b - a, name))
            if kernel in name:
                calls.append(pending)
                kern.append(b - a)
                pending = []
        if kern:
            return dict(
                ms=statistics.median(sum(t for t, _ in c) for c in calls) / 1e3,
                kernel_ms=statistics.median(kern) / 1e3,
                device_ops_per_call=max(len(c) for c in calls),
                device_op_names=sorted({n[:60] for c in calls for _, n in c}),
            )
    return dict(ms=None, kernel_ms=None, device_ops_per_call="not measured", device_op_names=[])


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


def camera_labels_vs_reference(cfg, points, mask, out) -> dict:
    """A camera-grid step's ``label_components`` labels against the plain
    reference's (``cardbench/reference/components.py``, ``compare``), on
    the scan in the world frame as the step put it."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "cardbench", "reference"))
    import components

    from dynamic_direct_lidar_odometry_tpu_torch.core import se3

    T = out.odom.T
    world = se3.transform_points(T, torch.as_tensor(points, dtype=torch.float32, device=T.device))
    return components.compare(cfg.detection, out.detections.labels.cpu().numpy(), world.cpu().numpy(),
                              np.asarray(torch.as_tensor(mask).cpu()), T[:3, 3].cpu().numpy())


def run_slice(cfg, points, masks, stamps, device, timed: bool = False, keep=None, eager=False):
    """DDLO through the port's public entry points: init on scan 0, then
    ``pipeline.step`` per scan (a graph replay; ``eager``:
    ``pipeline.step_eager``). Returns poses (N,4,4) and per-scan records;
    with ``timed`` each step is timed with CUDA events. ``keep``: a scan
    index whose step inputs and tracker state before it are kept in the
    record (for phase 6)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.detection import detection

    state = pipeline.init_state(cfg, points[0], masks[0], float(stamps[0]), device=device)
    poses = [state.odom.T.cpu().numpy()]
    records = []
    for i in range(1, len(points)):
        before = state
        if timed:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        state, out = (pipeline.step_eager if eager else pipeline.step)(
            cfg, state, points[i], masks[i], float(stamps[i]))
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
        if cfg.detection.window_row_min is not None:
            rec["outside_window"] = detection.labels_outside_window(cfg, out.detections.labels)
        if cfg.detection.residual_grid == "camera":
            rec["labels_vs_reference"] = camera_labels_vs_reference(cfg, points[i], masks[i], out)
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


def rot_err(Ra, Rb) -> float:
    """||Ra - Rb||_F / sqrt(2): the rotation angle between them, to first order."""
    return float(np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)) / np.sqrt(2.0))


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


def stress_inputs(query, s2m_target):
    """Two stress inputs for the 1-NN kernels at the S2M shape. Ties: a
    target whose every point appears four times (copies 16,384 rows
    apart, two of them rotated by 77 and -300 rows, so equal distances
    straddle stage, chunk and split boundaries: every query has exact
    ties, which go to the lowest index). Long list: the submap's real
    points repeated to fill all 65,536 rows and sorted by x (compact
    chunks), against a query cloud whose first tile spans the submap's
    box, so that tile's list holds every chunk while the others hold a
    few."""
    import torch

    a = s2m_target[:16384]
    ties = torch.cat([a, a.roll(77, 0), a, a.roll(-300, 0)]).contiguous()
    real = s2m_target[torch.all(s2m_target < 5.0e5, dim=1)]
    reps = -(-s2m_target.shape[0] // real.shape[0])
    long_t = real.repeat(reps, 1)[: s2m_target.shape[0]]
    long_t = long_t[torch.argsort(long_t[:, 0], stable=True)].contiguous()
    long_q = query.clone()
    long_q[0] = real.amin(dim=0)
    long_q[1] = real.amax(dim=0)
    return ties, long_q, long_t


PTXAS_NAMES = {"nn1_kernelILb0": "nn1_sparse", "nn1_kernelILb1": "nn1_dense",
               "knn_classes_kernelILb0": "knn_classes", "knn_classes_kernelILb1": "knn_classes_sparse",
               "jv_solve_kernel": "jv_solve", "plane_reg_kernel": "regularize_plane",
               "window_cov_kernel": "window_plane_cov",
               "set_cond_kernel": "set_cond", "lm_propose_kernel": "lm_propose",
               "lm_decide_kernel": "lm_decide", "lm_inner_kernel": "lm_inner", "span_kernel": "span",
               "seg_count_kernel": "segment_objects", "seg_select_kernel": "segment_objects",
               "seg_stats_kernel": "segment_objects", "seg_finish_kernel": "segment_objects"}


def ptxas_report(log: str) -> dict:
    """Registers, spill bytes and stack frame of each kernel, from nvcc's
    ``-Xptxas -v`` output; a kernel built in several instances (template
    arguments) gets the most registers and stack of any and the sum of
    their spills."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((v for k, v in PTXAS_NAMES.items() if k in m.group(1)), m.group(1))
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        rec = out[cur]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rec["spill_bytes"] = rec.get("spill_bytes", 0) + int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = max(rec.get("registers", 0), int(m.group(1)))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            rec["stack_bytes"] = max(rec.get("stack_bytes", 0), int(m.group(1)))
    return out


KERNEL_NAMES = {"nn1_sparse": "nn1_kernel<false>", "nn1_dense": "nn1_kernel<true>",
                "nn1_sparse_batched": "nn1_kernel<false>",
                "knn_classes": "knn_classes_kernel<false>",
                "knn_classes_sparse": "knn_classes_kernel<true>",
                "jv_solve": "jv_solve_kernel", "regularize_plane": "plane_reg_kernel",
                "window_plane_cov": "window_cov_kernel",
                "lm_propose": "lm_propose_kernel", "lm_decide": "lm_decide_kernel",
                "lm_inner": "lm_inner_kernel", "span": "span_kernel",
                "segment_objects": "seg_finish_kernel"}  # a call's last kernel


def _record(kernel, case, Q, T, err, identical, pairs, nbytes, call, plain_ms, cdist_ms, **extra):
    """One phase-3 case: ``ms`` is the device time of every operation one
    wrapper call puts on the card (profiler; the 1-NN key fill and the
    kernel), ``kernel_ms`` the kernel's alone, ``call_ms`` the wrapper
    call between CUDA events (host time included); ``counted_per_call``
    the ``LAUNCHES`` counts one call adds."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    b, by = bound_ms(pairs, nbytes)
    dev = device_times(call, KERNEL_NAMES[kernel])
    call_ms = cuda_ms(call)
    timer = "profiler"
    if dev["ms"] is None:
        dev["ms"], timer = call_ms, "events"
    before = dict(nn_cuda.LAUNCHES)
    call()
    counted = {k: v - before.get(k, 0) for k, v in nn_cuda.LAUNCHES.items() if v != before.get(k, 0)}
    rec = dict(kernel=kernel, case=case, Q=Q, T=T, max_abs_err=err, all_rows_identical=identical,
               pairs=pairs, bound_ms=b, bound_by=by, timer=timer, call_ms=call_ms,
               plain_ms=plain_ms, cdist_ms=cdist_ms, counted_per_call=counted, **dev, **extra)
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
    """The sparse 1-NN kernel against its plain version on the same CSR
    lists: identical index and distance on every row, in radius or not."""
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
    torch.cuda.synchronize()
    same = bool(torch.equal(ik, ir) and torch.equal(dk, dr))
    err = float((dk - dr).abs().max())
    check(same, f"nn1_sparse {name}: kernel differs from its plain version (max |d| {err})")
    pairs = float(counts.sum()) * q_tile * t_chunk
    cols = [
        (lists[i, :c, None].long() * t_chunk + torch.arange(t_chunk, device=q.device)).reshape(-1)
        for i, c in enumerate(counts.tolist())
    ]
    tpad = prep.tt.T.contiguous()
    return _record(
        "nn1_sparse", name, Q, target.shape[0], err, same,
        pairs, (q.numel() + prep.tt.numel()) * 4 + 8 * Q,
        lambda: nn_cuda.nn1_sparse_chunks(*args),
        cuda_ms(lambda: nn_cuda.nn1_sparse_reference(*args)),
        _cdist_tiles(q, tpad, q_tile, cols),
        radius=radius, in_radius=int((dr[:Q] < radius * radius).sum()),
        active_chunk_share=float(counts.float().mean()) / lists.shape[1],
        max_tile_chunks=int(counts.max()),
    )


def check_sparse_batched(name, queries, targets, radius):
    """The batched sparse entry (B stacked problems, one launch) against
    its plain version and against B single-problem kernel calls on the
    same lists: identical index and distance on every row."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    B, Q = queries.shape[:2]
    q_tile, t_chunk = 1024, 512
    prep = nn_cuda.prepare_sparse_targets(targets, t_chunk)
    n_chunks = prep.t_lo.shape[1]
    t_stream = prep.tt.shape[1] // B
    q = nn_cuda._pad_dim1(queries, q_tile, 1.0e6)
    n_tiles = q.shape[1] // q_tile
    counts, lists = nn_cuda.sparse_chunk_lists(
        nn_cuda._tile_overlap(q, prep.t_lo, prep.t_hi, radius, q_tile).flatten(0, 1))
    lists = lists + (torch.arange(B, dtype=torch.int32, device=q.device) * n_chunks).repeat_interleave(n_tiles)[:, None]
    qs = q.reshape(-1, 3).contiguous()
    args = (qs, prep.tt, counts, lists, q_tile, t_chunk, n_tiles, t_stream)
    ik, dk = nn_cuda.nn1_sparse_batched_chunks(*args)
    ir, dr = nn_cuda.nn1_sparse_batched_reference(*args)
    single_i, single_d = [], []
    for b in range(B):
        one = nn_cuda.prepare_sparse_target(targets[b], t_chunk)
        c, lst = nn_cuda.tile_chunk_lists(q[b].contiguous(), one, radius, q_tile)
        i1, d1 = nn_cuda.nn1_sparse_chunks(q[b].contiguous(), one.tt, c, lst, q_tile, t_chunk)
        single_i.append(i1)
        single_d.append(d1)
    torch.cuda.synchronize()
    same_plain = bool(torch.equal(ik, ir) and torch.equal(dk, dr))
    same_single = bool(torch.equal(ik, torch.cat(single_i)) and torch.equal(dk, torch.cat(single_d)))
    err = float((dk - dr).abs().max())
    check(same_plain, f"nn1_sparse_batched {name}: kernel differs from its plain version (max |d| {err})")
    check(same_single, f"nn1_sparse_batched {name}: differs from {B} single calls")
    pairs = float(counts.sum()) * q_tile * t_chunk
    ar = torch.arange(t_chunk, device=q.device)
    cols = [(lists[i, :c, None].long() * t_chunk + ar).reshape(-1) for i, c in enumerate(counts.tolist())]
    return _record(
        "nn1_sparse_batched", name, B * Q, targets.shape[1], err, same_plain and same_single,
        pairs, (qs.numel() + prep.tt.numel()) * 4 + 8 * B * Q,
        lambda: nn_cuda.nn1_sparse_batched_chunks(*args),
        cuda_ms(lambda: nn_cuda.nn1_sparse_batched_reference(*args)),
        _cdist_tiles(qs, prep.tt.T.contiguous(), q_tile, cols),
        radius=radius, B=B, in_radius=int((dr < radius * radius).sum()),
        rows_identical_to_single_calls=same_single, max_tile_chunks=int(counts.max()),
    )


def fma_tie_rows(m=4000, seed=0):
    """Symmetric rows on which one of the chain's fused multiply-adds (the
    first lane of the cross product c01, ``fma(a01, a12, -ftz(a02 c11))``)
    has its product on an f32 midpoint, ``(1 + 2^-12)^2``, and a tiny
    addend on the product's side: a double-rounded emulation misses the
    fused result there (``tests/test_torch_plane_kernel.py``)."""
    rng = np.random.default_rng(seed)
    t = np.float32(1 + 2.0**-12)
    d = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    s = np.where(rng.random(m) < 0.5, -1, 1).astype(np.float32)
    x = np.zeros((m, 3, 3), np.float32)
    x[:, 0, 0], x[:, 1, 1], x[:, 2, 2] = d[:, 0], d[:, 1], d[:, 2]
    x[:, 0, 1] = x[:, 1, 0] = s * t
    x[:, 1, 2] = x[:, 2, 1] = t
    x[:, 0, 2] = x[:, 2, 0] = -s * np.float32(1e-20)
    return x


def _rows_not_bit_equal(a, b, real):
    """Finite-input rows whose 9 entries differ in any bit (NaN = NaN)."""
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    return int((~same.reshape(len(a), -1).all(axis=1) & real).sum())


def check_regularize(query, k):
    """``covariance.regularize_plane`` (the kernel) against
    ``regularize_plane_plain`` on the card and on the host, from the same
    covariances (the window path's at the bench scan, near-collinear,
    denormal-sized and FMA-tie ones): every finite row bit-equal, one
    launch per call. Timed at the main path's shape (the scan's 16,384
    window covariances)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, nn_cuda

    main = covariance._window_self_covariances(query, k)
    rng = np.random.default_rng(5)
    d = rng.standard_normal((4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (rng.uniform(-1, 1, (4096, 10, 1)) * d[:, None]
           + rng.standard_normal((4096, 10, 3)) * 10.0 ** rng.uniform(-6, 0, (4096, 1, 1)))
    c = pts - pts.mean(1, keepdims=True)
    deg = (np.einsum("nki,nkj->nij", c, c) / 10).astype(np.float32)
    deg[:64] *= np.float32(1e-19)
    raw = torch.cat([main, torch.as_tensor(deg, device=main.device),
                     torch.as_tensor(fma_tie_rows(), device=main.device)]).contiguous()
    real = torch.isfinite(raw).all(dim=(1, 2)).cpu().numpy()
    before = nn_cuda.LAUNCHES["regularize_plane"]
    kern = covariance.regularize_plane(raw)
    torch.cuda.synchronize()
    launched = nn_cuda.LAUNCHES["regularize_plane"] - before
    kern = kern.cpu().numpy()
    plain = covariance.regularize_plane_plain(raw).cpu().numpy()
    host = covariance.regularize_plane_plain(raw.cpu()).numpy()
    err = float(np.abs(np.nan_to_num(kern - plain))[real].max())
    m = main.shape[0]
    f32_ms = m * PLANE_F32_OPS / FP32_ISSUE_PER_S * 1e3
    f64_ms = m * PLANE_F64_OPS / FP64_ISSUE_PER_S * 1e3
    bytes_ms = m * 72 / HBM_BYTES_PER_S * 1e3
    bound, by = max((bytes_ms, "bytes"), (max(f32_ms, f64_ms), "operations"))
    dev = device_times(lambda: covariance.regularize_plane(main), KERNEL_NAMES["regularize_plane"])
    call_ms = cuda_ms(lambda: covariance.regularize_plane(main))
    timer = "profiler"
    if dev["ms"] is None:
        dev["ms"], timer = call_ms, "events"
    rec = dict(
        kernel="regularize_plane", case="bench_window_16384", rows=int(real.sum()), M=m,
        rows_not_bit_equal_card_plain=_rows_not_bit_equal(kern, plain, real),
        rows_not_bit_equal_host=_rows_not_bit_equal(kern, host, real),
        rows_not_bit_equal_plain_card_vs_host=_rows_not_bit_equal(plain, host, real),
        max_abs_err=err, launches_per_call=launched, timer=timer, call_ms=call_ms,
        plain_ms=cuda_ms(lambda: covariance.regularize_plane_plain(main), reps=5),
        plain_device_ops_per_call=device_busy_ms(lambda: covariance.regularize_plane_plain(main))[1],
        eigh_ms=cuda_ms(lambda: torch.linalg.eigh(main), reps=5),
        bound_ms=bound, bound_by=by, bound_parts_ms=dict(bytes=bytes_ms, f32=f32_ms, f64=f64_ms),
        **dev,
    )
    print("kernel check " + json.dumps(rec), flush=True)
    check(launched == 1, f"regularize_plane: {launched} launches for one call")
    check(rec["rows_not_bit_equal_card_plain"] == 0 and rec["rows_not_bit_equal_host"] == 0,
          f"regularize_plane: the kernel differs from its plain version on "
          f"{rec['rows_not_bit_equal_card_plain']} rows (card) / {rec['rows_not_bit_equal_host']} (host)")
    return rec


def window_cov_cases(cfg, query, s2m_t, odd_q, k):
    """(name, points, mask, k) for ``ddlo_window_plane_cov``: the bench
    scan (16,384 rows) at the config's k and at 20, a keyframe cloud of
    8,192 (the scan voxelized as ``update_keyframes`` stores it), the CLI
    configuration's 65,536 (the phase's submap), 15,607 rows (no multiple
    of 128, every 13th a sentinel), a whole block of sentinels inside the
    scan, and its real points three times each (the k-th and (k+1)-th
    distances tie exactly)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import filters

    def real(p):
        return torch.all(p < 5.0e5, dim=1)

    kp, km = filters.voxel_downsample(query, real(query), cfg.preprocessing.voxel_submap.res, 8192)
    blank = query.clone()
    blank[5 * 128:6 * 128] = 1.0e6
    ties = query[real(query)].repeat_interleave(3, dim=0)
    cases = [
        (f"bench_16384_k{k}", query, k),
        ("bench_16384_k20", query, 20),
        ("keyframe_8192", kp, k),
        ("cli_65536", s2m_t, k),
        ("nonmultiple_sentinels", odd_q, k),
        ("sentinel_block", blank, k),
        ("ties", ties, k),
    ]
    return [(name, p.contiguous(), km if name == "keyframe_8192" else real(p), kk) for name, p, kk in cases]


def check_window_cov(cases):
    """``covariance.window_plane_covariances`` (the kernel) against
    ``window_plane_covariances_plain`` on the card, from the same points:
    every row bit-equal, one launch per call. Each case prints device ms
    (the kernel and its count add), call ms, plain ms, ``torch.topk`` of
    the same distances alone (the plain version's selection) and its
    bound: 8 FP32 operations a (live row, candidate) pair against 49
    bytes a row (points, mask and output once)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, nn_cuda

    recs = []
    for name, p, m, k in cases:
        before = nn_cuda.LAUNCHES["window_plane_cov"]
        kern = covariance.window_plane_covariances(p, m, k)
        torch.cuda.synchronize()
        launched = nn_cuda.LAUNCHES["window_plane_cov"] - before
        kern = kern.cpu().numpy()
        plain = covariance.window_plane_covariances_plain(p, m, k).cpu().numpy()
        real = np.isfinite(plain).reshape(len(plain), -1).all(axis=1)
        off = _rows_not_bit_equal(kern, plain, np.ones(len(plain), bool))
        n, live = p.shape[0], int(m.sum())
        # a masked row is the identity whatever its window: only live rows
        # need their 384 pairs
        pairs = live * 3 * covariance.WINDOW_BLOCK
        b, by = bound_ms(pairs, 49 * n)
        call = lambda: covariance.window_plane_covariances(p, m, k)  # noqa: E731
        dev = device_times(call, KERNEL_NAMES["window_plane_cov"])
        call_ms = cuda_ms(call)
        timer = "profiler"
        if dev["ms"] is None:
            dev["ms"], timer = call_ms, "events"
        d2 = covariance._window_d2(p)[1]
        rec = dict(
            kernel="window_plane_cov", case=name, N=n, k=k, rows_finite=int(real.sum()),
            live_rows=live, rows_not_bit_equal=off,
            max_abs_err=float(np.abs(np.nan_to_num(kern - plain)).max()), launches_per_call=launched,
            timer=timer, call_ms=call_ms, plain_ms=cuda_ms(lambda: covariance.window_plane_covariances_plain(p, m, k),
                                                           reps=3),
            topk_ms=cuda_ms(lambda: torch.topk(d2, k, dim=-1, largest=False, sorted=True), reps=5),
            bound_ms=b, bound_by=by, pairs=pairs, **dev,
        )
        del d2
        print("kernel check " + json.dumps(rec), flush=True)
        check(launched == 1, f"window_plane_cov {name}: {launched} launches for one call")
        check(off == 0, f"window_plane_cov {name}: the kernel differs from its plain version on {off} rows")
        check(rec["device_ops_per_call"] in (2, "not measured"),
              f"window_plane_cov {name}: {rec['device_ops_per_call']} device operations a call")
        recs.append(rec)
    return recs


def jv_cases(device):
    """(name, cost, row_valid) for ``jv_solve`` at N = 32, 64, 128 and 256
    (N = 256: the kernel's instance that reads rows from device memory):
    uniform costs, integer ties, BIG rows and columns, all BIG and NaN
    costs, with all, half, a quarter or no rows valid (or no mask); and at
    N = 33 and 64 a cost stored 4 bytes past a 16-byte boundary (the bulk
    copy's unaligned edges)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian

    rng = np.random.default_rng(11)
    out = []
    for N in (32, 64, 128, 256):
        for kind in ("uniform", "ties", "big", "all_big", "nan"):
            if kind == "uniform":
                c = rng.uniform(0, 10, (N, N))
            elif kind == "ties":
                c = rng.integers(0, 4, (N, N)).astype(np.float64)
            elif kind == "big":
                c = rng.uniform(0, 5, (N, N))
                c[rng.random(N) < 0.3] = hungarian.BIG
                c[:, rng.random(N) < 0.2] = hungarian.BIG
            elif kind == "all_big":
                c = np.full((N, N), hungarian.BIG)
            else:
                c = rng.integers(0, 20, (N, N)).astype(np.float64)
                c[rng.random((N, N)) < 0.1] = np.nan
            cost = torch.as_tensor(c.astype(np.float32), device=device)
            for rv_name, rv in (("none", None), ("all", np.ones(N, bool)), ("half", rng.random(N) < 0.5),
                                ("quarter", np.arange(N) < N // 4), ("empty", np.zeros(N, bool))):
                out.append((f"{kind}_N{N}_{rv_name}", cost,
                            None if rv is None else torch.as_tensor(rv, device=device)))
    for N in (33, 64):
        c = rng.integers(0, 6, (N, N)).astype(np.float32)
        store = torch.zeros(N * N + 1, dtype=torch.float32, device=device)
        cost = store[1:].view(N, N)
        cost.copy_(torch.as_tensor(c, device=device))
        for rv_name, rv in (("none", None), ("half", rng.random(N) < 0.5)):
            out.append((f"ties_unaligned_N{N}_{rv_name}", cost,
                        None if rv is None else torch.as_tensor(rv, device=device)))
    return out


def _jv_timing(name, cost, rv) -> dict:
    """Device ms, call ms, plain ms, bound and launch floor of one solve,
    with its path steps (the plain version's host reads per step) and the
    kernel's instance (the cost in shared memory or read from device
    memory)."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, nn_cuda

    N = cost.shape[0]
    hungarian.HOST_READS.clear()
    hungarian.solve_plain(cost, rv)
    steps = hungarian.HOST_READS["path"]
    valid = N if rv is None else int(rv.sum())
    # bytes: the cost read once, row_valid, col_of_row; operations: per
    # path step two subtractions and a potential update per column
    bytes_ms = (4 * N * N + N + 4 * N) / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * (N + 1) * steps / FP32_ISSUE_PER_S * 1e3
    dev = device_times(lambda: hungarian.solve(cost, rv), KERNEL_NAMES["jv_solve"])
    call_ms = cuda_ms(lambda: hungarian.solve(cost, rv))
    timer = "profiler"
    if dev["ms"] is None:
        dev["ms"], timer = call_ms, "events"
    bound, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    shared_max = nn_cuda.build()["jv_solve"].lib.ddlo_jv_shared_max_n()
    return dict(timed_case=name, N=N, valid_rows=valid, path_steps=steps, timer=timer, call_ms=call_ms,
                plain_ms=cuda_ms(lambda: hungarian.solve_plain(cost, rv), reps=5),
                bound_ms=bound, bound_by=by, launch_floor_ms=launch_floor_ms(),
                instance="cost in shared memory" if N <= shared_max else "rows from device memory",
                warps=-(-(N + 1) // (32 * min(4, (N + 32) // 32))),
                note="serial: bound by latency, not by bytes or operations", **dev)


def check_jv(cases, tag, time_case=None, also_time=()):
    """``hungarian.solve`` (the kernel) against ``solve_plain`` on the card
    on every case: identical ``col_of_row``. ``time_case``: the index of
    the case to time (:func:`_jv_timing`); ``also_time``: the names of
    cases timed beside it (``timed_others``)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian

    differ = []
    for name, cost, rv in cases:
        got, want = hungarian.solve(cost, rv), hungarian.solve_plain(cost, rv)
        if not torch.equal(got, want):
            differ.append(name)
    torch.cuda.synchronize()
    rec = dict(kernel="jv_solve", case=tag, cases=len(cases), cases_not_identical=differ, max_abs_err=0.0)
    if time_case is not None:
        rec.update(_jv_timing(*cases[time_case]))
    if also_time:
        rec["timed_others"] = [_jv_timing(*c) for c in cases if c[0] in also_time]
    print("kernel check " + json.dumps(rec), flush=True)
    check(not differ, f"jv_solve {tag}: the kernel differs from solve_plain on {differ}")
    return rec


def lm_trial_cases(dev):
    """The lambda trial kernels' synthetic cases from
    ``tests/torch_lm_cases.py`` on the card: (propose cases, decide
    cases), each a list of (name, arguments)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_lm_cases as lc

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    def on(xs):
        return tuple(None if x is None else x.to(dev) for x in xs)

    propose = [(name, on(lc.as_tensors(*arrays))) for name, *arrays in lc.propose_cases()]
    propose.append(("half_angle_sweep_2^20", on(lc.half_angle_sweep())))
    decide = []
    for name, make in lc.DECIDE_CASES.items():
        ins, st, _ = make()
        decide.append((name, (on(ins), gicp.TrialState(*on(st)), lc.S)))
    return propose, decide


@contextlib.contextmanager
def recorded_trials():
    """Every lambda loop on the card's path in the block: the inputs of
    ``gicp.TORCH.lm_inner`` (cloned before the call: it updates lambda in
    place) and each call's trial counts (read at the end of the block,
    not during it), the split trials (error re-evaluations,
    ``gicp._compute_error``) and the calls of the pieces that no loop on
    the card may run eagerly (the plain versions, the eager solve and
    exponential)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import se3
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    rec = dict(inner=[], loops=0, trials=0, split_trials=0, eager_pieces=0)
    counts = []

    def clone(xs):
        return tuple(None if x is None else x.clone() for x in xs)

    def inner(*a, _real=gicp.TORCH.lm_inner):
        *ins, settings = a
        rec["inner"].append((clone(ins), settings))
        rec["loops"] += 1
        st = _real(*a)
        counts.append(st.j.sum())
        return st

    def error(*a, _real=gicp._compute_error, **k):
        rec["split_trials"] += 1
        return _real(*a, **k)

    def piece(real):
        def f(*a, **k):
            rec["eager_pieces"] += 1
            return real(*a, **k)
        return f

    patches = [(gicp.TORCH, "lm_inner", inner), (gicp, "_compute_error", error)]
    patches += [(m, n, piece(getattr(m, n))) for m, n in (
        (gicp, "lm_inner_plain"), (gicp, "lm_propose_plain"), (gicp, "lm_decide_plain"),
        (gicp, "solve6_ldlt"), (gicp, "_se3_exp_card"), (se3, "se3_exp"))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield rec
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
        rec["trials"] = int(torch.stack(counts).sum()) if counts else 0


_FLOOR = {}


def launch_floor_ms() -> float:
    """The device time of a one-element add (median of 20): what any
    kernel launch costs on the card, whatever it computes."""
    import torch

    if "ms" not in _FLOOR:
        x = torch.zeros(1, device="cuda")
        _FLOOR["ms"] = device_times(lambda: x.add_(1.0), "elementwise")["kernel_ms"]
    return _FLOOR["ms"]


def _streams_differ(a, b, n: int) -> int:
    """Streams (of n, the leading rows) whose entries differ in any bit
    (NaN = NaN)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    same = a == b
    if a.is_floating_point():
        same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return int((~same.reshape(n, -1).all(dim=1)).sum())


def _lm_timing(kernel, call, plain, streams, ops, nbytes) -> dict:
    """Device ms, call ms, plain ms, bound and launch floor of one call
    (``ops`` f32 operations per stream, ``nbytes`` the call's bytes)."""
    dev = device_times(call, KERNEL_NAMES[kernel])
    call_ms = cuda_ms(call)
    timer = "profiler"
    if dev["ms"] is None:
        dev["ms"], timer = call_ms, "events"
    ops_ms = streams * ops / FP32_ISSUE_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    return dict(timed_streams=streams, timed_bytes=nbytes, timer=timer, call_ms=call_ms, plain_ms=cuda_ms(plain, reps=5),
                plain_device_ops_per_call=device_busy_ms(plain)[1], bound_ms=bound, bound_by=by,
                bound_parts_ms=dict(bytes=bytes_ms, f32=ops_ms), launch_floor_ms=launch_floor_ms(),
                note="bound by latency: the launch floor, not bytes or operations, sets the time", **dev)


def check_lm_propose(cases, tag, time_case=None):
    """``gicp.lm_propose`` (the kernel) against ``lm_propose_plain`` on
    the card on every case: d and delta bit-equal on every stream, one
    launch per call. ``time_case``: the index of the case to time."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, nn_cuda

    differ, streams, err = [], 0, 0.0
    before = nn_cuda.LAUNCHES["lm_propose"]
    for name, args in cases:
        n = args[2].numel()
        (d, delta), (pd, pdelta) = gicp.lm_propose(*args), gicp.lm_propose_plain(*args)
        bad = max(_streams_differ(d, pd, n), _streams_differ(delta, pdelta, n))
        streams += n
        if bad:
            differ.append((name, bad))
        err = max(err, float(torch.nan_to_num(delta - pdelta).abs().max()),
                  float(torch.nan_to_num(d - pd).abs().max()))
    torch.cuda.synchronize()
    launched = nn_cuda.LAUNCHES["lm_propose"] - before
    rec = dict(kernel="lm_propose", case=tag, cases=len(cases), streams=streams,
               cases_not_identical=differ, max_abs_err=err, launches=launched)
    if time_case is not None:
        name, args = cases[time_case]
        rec.update(timed_case=name, linalg_solve_ms=cuda_ms(
            lambda: torch.linalg.solve(args[0] + args[2][..., None, None] * torch.eye(6, device=args[0].device),
                                       -args[1]), reps=5),
            **_lm_timing("lm_propose", lambda: gicp.lm_propose(*args), lambda: gicp.lm_propose_plain(*args),
                         args[2].numel(), LM_PROPOSE_F32_OPS,
                         lm_propose_bytes(args[2].numel(), len(args) > 3 and args[3] is not None)))
    print("kernel check " + json.dumps(rec), flush=True)
    check(launched == len(cases), f"lm_propose: {launched} launches for {len(cases)} calls")
    check(not differ, f"lm_propose {tag}: the kernel differs from its plain version on {differ}")
    return rec


def check_lm_decide(cases, tag, time_case=None):
    """``gicp.lm_decide`` (the kernel) against ``lm_decide_plain`` on the
    card, each on its own copy of the same state: every field of the
    updated state bit-equal on every stream, one launch per call."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, nn_cuda

    def fresh(st):
        return gicp.TrialState(*(x.clone() for x in st))

    differ, streams, err = [], 0, 0.0
    before = nn_cuda.LAUNCHES["lm_decide"]
    for name, (ins, st, settings) in cases:
        n = ins[0].numel()
        got, want = fresh(st), fresh(st)
        gicp.lm_decide(*ins, got, settings)
        gicp.lm_decide_plain(*ins, want, settings)
        bad = {f: k for f, a, b in zip(gicp.TrialState._fields, got, want)
               if (k := _streams_differ(a, b, n if a.dim() else 1))}
        streams += n
        if bad:
            differ.append((name, bad))
        err = max(err, max(float(torch.nan_to_num(a.float() - b.float()).abs().max()) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    launched = nn_cuda.LAUNCHES["lm_decide"] - before
    rec = dict(kernel="lm_decide", case=tag, cases=len(cases), streams=streams,
               cases_not_identical=differ, max_abs_err=err, launches=launched)
    if time_case is not None:
        name, (ins, st, settings) = cases[time_case]
        a, b = fresh(st), fresh(st)
        # every timed call repeats the trial on the state its warm-up call
        # left: count the bytes of that call's decisions
        after = fresh(st)
        gicp.lm_decide_plain(*ins, after, settings)
        acc, crj = gicp.lm_decide_plain(*ins, fresh(after), settings)
        n_acc, n_end = int(acc.sum()), int((acc | crj).sum())
        rec.update(timed_case=name, timed_accepted=n_acc, timed_ended=n_end, **_lm_timing(
            "lm_decide", lambda: gicp.lm_decide(*ins, a, settings),
            lambda: gicp.lm_decide_plain(*ins, b, settings), ins[0].numel(), LM_DECIDE_F32_OPS,
            lm_decide_bytes(ins[0].numel(), n_acc, n_end)))
    print("kernel check " + json.dumps(rec), flush=True)
    check(launched == len(cases), f"lm_decide: {launched} launches for {len(cases)} calls")
    check(not differ, f"lm_decide {tag}: the kernel differs from its plain version on {differ}")
    return rec


def lm_inner_cases(dev):
    """``gicp.lm_inner``'s synthetic cases from ``tests/torch_lm_cases.py``
    on the card, each (name, (arguments, settings)): GICP-like streams at
    B = 1 and 8 on the shared-memory route (16,384 points, the bench
    cloud; 17,000, no multiple of P; 1,001, streams off a 16-byte
    boundary) and the device-memory route (65,536, the CLI cloud); the
    B = 8 batches hold a free loop, a far start, a loop whose every step
    climbs until lm_max_iterations, a step d = 0, a degenerate stream and
    one that does not run; also lm_max_iterations 3 and 0."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_lm_cases as lc

    out = []
    for B, N in ((1, 16384), (8, 16384), (8, 17000), (3, 1001), (1, 65536), (8, 65536)):
        args = [x.to(dev) for x in lc.inner_case(B, N, seed=B + N, lead=B > 1)]
        out.append((f"B{B}_N{N}", (args, lc.S)))
    args = [x.to(dev) for x in lc.inner_case(8, 16384, seed=7)]
    out += [("B8_N16384_cap3", (args, lc.S._replace(lm_max_iterations=3))),
            ("B8_N16384_cap0", (args, lc.S._replace(lm_max_iterations=0)))]
    return out


def bench_inner_cases(rec):
    """``gicp.lm_inner``'s cases from a recorded eager run (``recorded_trials``):
    every lambda loop at B = 1; the last 8 loops of the last loop's
    settings stacked (B = 8); the last loop's 16,384 points four times
    over, each copy rolled, at the CLI cloud's 65,536 (the device-memory
    route), at B = 1 and stacked with itself moved (B = 8)."""
    import torch

    loops = [(f"loop_{i}", (list(ins), st)) for i, (ins, st) in enumerate(rec["inner"])]
    settings = rec["inner"][-1][1]
    same = [ins for ins, st in rec["inner"] if st == settings][-8:]
    cols = [[ins[k] for ins in same] for k in range(10)]
    batch = [None if c[0] is None else torch.stack(c) for c in cols]
    last = list(rec["inner"][-1][0])
    N = last[4].shape[0]
    big = list(last)
    for k in (4, 5, 6, 7):  # src, valid, M, B
        big[k] = torch.cat([last[k].roll(777 * c, 0) for c in range(4)])
    big8 = [None if x is None else torch.stack([x] * 8) for x in big]
    big8[4] = big8[4] + torch.arange(8, device=big8[4].device, dtype=torch.float32)[:, None, None] * 0.01
    return loops, [(f"stacked_{len(same)}_loops", (batch, settings)),
                   (f"last_loop_x4_N{4 * N}", (big, settings)), (f"last_loop_x4_N{4 * N}_B8", (big8, settings))]


def bench_split_trials(rec):
    """The split trial's cases from a recorded eager run: each lambda
    loop's first trial, as ``lm_propose`` and ``lm_decide`` would run it
    (the proposal, ``xi``, ``y0`` and ``yi`` from the plain pieces)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    propose, decide = [], []
    for i, ((x0, lam, H, b, src, valid, M, B, deg, run), s) in enumerate(rec["inner"]):
        propose.append((f"loop_{i}", (H, b, lam)))
        d, delta = gicp.lm_propose_plain(H, b, lam)
        xi = gicp._compose_ltr(delta, x0)
        ins = (gicp.error_fixed(x0, src, valid, M, B), gicp.error_fixed(xi, src, valid, M, B), d, b, delta, xi)
        f = torch.zeros((), dtype=torch.bool, device=lam.device)
        st = gicp.TrialState(lam.clone(), torch.full_like(lam, 2.0), x0.clone(),
                             torch.eye(4, device=lam.device), f.clone(), f.clone(), f.clone(), ~deg,
                             torch.zeros((), dtype=torch.int32, device=lam.device))
        decide.append((f"loop_{i}", (ins, st, s)))
    return propose, decide


def check_lm_inner(cases, tag, time_case=None):
    """``gicp.lm_inner`` (the kernel) against ``lm_inner_plain`` on the
    card, each on its own copy of lambda: every field of the returned
    state bit-equal on every stream, one launch per call. ``time_case``:
    the index of the case to time (lambda evolves over the timed calls,
    as a caller's would; ``timed_trials`` are the last call's)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, nn_cuda

    lib = nn_cuda.build()["lm_trial"].lib
    check(lib.ddlo_lm_inner_layout() == gicp.LM_CLUSTER * 1000 + gicp.LM_THREADS,
          "lm_inner: the kernel's cluster layout is not gicp.LM_CLUSTER x LM_THREADS")
    shared_max = lib.ddlo_lm_inner_shared_max_n()

    def both(args, settings):
        a, b = list(args), list(args)
        a[1], b[1] = args[1].clone(), args[1].clone()
        return gicp.lm_inner(*a, settings), gicp.lm_inner_plain(*b, settings)

    differ, streams, err, trials, routes = [], 0, 0.0, 0, collections.Counter()
    before = nn_cuda.LAUNCHES["lm_inner"]
    for name, (args, settings) in cases:
        n = args[1].numel()
        got, want = both(args, settings)
        bad = {f: k for f, a, b in zip(gicp.TrialState._fields, got, want) if (k := _streams_differ(a, b, n))}
        streams += n
        trials += int(want.j.sum())
        routes["shared" if args[4].shape[-2] <= shared_max else "device"] += 1
        if bad:
            differ.append((name, bad))
        err = max(err, max(float(torch.nan_to_num(a.float() - b.float()).abs().max()) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    launched = nn_cuda.LAUNCHES["lm_inner"] - before
    rec = dict(kernel="lm_inner", case=tag, cases=len(cases), streams=streams, trials=trials,
               routes=dict(routes), shared_max_n=shared_max, cases_not_identical=differ, max_abs_err=err,
               launches=launched)
    if time_case is not None:
        name, (args, settings) = cases[time_case]
        a, b = list(args), list(args)
        a[1], b[1] = args[1].clone(), args[1].clone()
        call = lambda: gicp.lm_inner(*a, settings)  # noqa: E731
        plain = lambda: gicp.lm_inner_plain(*b, settings)  # noqa: E731
        dev = device_times(call, KERNEL_NAMES["lm_inner"])
        call_ms = cuda_ms(call)
        timer = "profiler"
        if dev["ms"] is None:
            dev["ms"], timer = call_ms, "events"
        st = call()
        active = int(st.j.gt(0).sum()) if settings.lm_max_iterations > 0 else 0
        t_trials = int(st.j.sum())
        N = args[4].shape[-2]
        ops = (t_trials + active) * N * LM_POINT_F32_OPS + t_trials * LM_TRIAL_F32_OPS
        ops_ms = ops / FP32_ISSUE_PER_S * 1e3
        nbytes = lm_inner_bytes(N, active, args[1].numel())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        rec.update(timed_case=name, timed_streams=args[1].numel(), timed_points=N, timed_trials=t_trials,
                   route="shared" if N <= shared_max else "device", timed_bytes=nbytes, timed_f32_ops=ops,
                   timer=timer, call_ms=call_ms, plain_ms=cuda_ms(plain, reps=5),
                   plain_device_ops_per_call=device_busy_ms(plain)[1], bound_ms=bound, bound_by=by,
                   bound_parts_ms=dict(bytes=bytes_ms, f32=ops_ms), launch_floor_ms=launch_floor_ms(), **dev)
    print("kernel check " + json.dumps(rec), flush=True)
    check(launched == len(cases), f"lm_inner: {launched} launches for {len(cases)} calls")
    check(not differ, f"lm_inner {tag}: the kernel differs from its plain version on {differ}")
    return rec


def check_trial_launches(tag, launches, rec):
    """An LM ``align`` without a process group runs each lambda loop as
    one ``lm_inner`` launch (``recorded_trials``' loops), no split trial
    (no ``lm_propose`` / ``lm_decide`` launch, no error re-evaluation)
    and no eager piece."""
    got = dict(lm_inner=launches.get("lm_inner", 0), lm_propose=launches.get("lm_propose", 0),
               lm_decide=launches.get("lm_decide", 0), loops=rec["loops"], trials=rec["trials"],
               split_trials=rec["split_trials"], eager_pieces=rec["eager_pieces"])
    print(f"{tag} lm loops " + json.dumps(got), flush=True)
    check(rec["loops"] > 0 and got["lm_inner"] == rec["loops"] and rec["trials"] >= rec["loops"],
          f"{tag}: lm_inner launched {got}")
    check(got["lm_propose"] == got["lm_decide"] == rec["split_trials"] == 0,
          f"{tag}: a split trial ran in an LM align without a group: {got}")
    check(rec["eager_pieces"] == 0, f"{tag}: {rec['eager_pieces']} eager trial pieces ran on the card")
    return got


def check_card_kernels(tag, launches, tracker_updates, covariance_calls, host_reads, window=None):
    """The launch checks of a phase on the main path: one ``jv_solve`` per
    ``tracker.update`` and no host read of the JV solve; one covariance
    kernel per ``plane_covariances`` call, ``window_plane_cov`` (the window
    path whole) or ``regularize_plane`` (the exact path's regularization).
    ``window``: True where every call takes the window path (no
    ``regularize_plane``), False where none does."""
    rec = dict(jv_solve=launches.get("jv_solve", 0), tracker_updates=tracker_updates,
               window_plane_cov=launches.get("window_plane_cov", 0),
               regularize_plane=launches.get("regularize_plane", 0), covariance_calls=covariance_calls,
               jv_host_reads=host_reads)
    print(f"{tag} card kernels " + json.dumps(rec), flush=True)
    check(host_reads == 0, f"{tag}: {host_reads} host reads in the JV solve")
    check(tracker_updates > 0, f"{tag}: no tracker update ran")
    check(rec["jv_solve"] == tracker_updates,
          f"{tag}: jv_solve launched {rec['jv_solve']} times for {tracker_updates} tracker updates")
    check(rec["window_plane_cov"] + rec["regularize_plane"] == covariance_calls,
          f"{tag}: window_plane_cov / regularize_plane launched {rec['window_plane_cov']} / "
          f"{rec['regularize_plane']} times for {covariance_calls} covariance calls")
    if window is not None:
        other = "regularize_plane" if window else "window_plane_cov"
        check(rec[other] == 0, f"{tag}: {other} launched {rec[other]} times")
    return rec


@contextlib.contextmanager
def main_path_counts(tag=None, window=None):
    """The main path's kernel launches (by the wrappers' names), tracker
    updates and covariance calls over the block, counted ON THE DEVICE
    (``utils.profiling.device_counts``): the block's steps are graph
    replays, which launch kernels without calling the wrappers, so the
    wrappers' host counts (``nn_cuda.LAUNCHES``) advance only at capture.
    The counts start at 0 on entry; a graph captured in the block leaves
    its eager warm-up uncounted, so only the replays count. With ``tag``,
    :func:`check_card_kernels` holds them (``window`` as it takes it). Yields a dict filled on exit:
    launches by kernel name, ``tracker_updates``, ``covariance_calls``
    and ``ccl_sweeps``."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    out = {}
    hungarian.HOST_READS.clear()
    with profiling.device_counts("cuda") as counts:
        yield out
    out.update({k: 0 for k in KERNELS}, tracker_updates=0, covariance_calls=0, ccl_sweeps=0)
    out.update(counts)
    PATH_LAUNCHES.update({k: out[k] for k in ("lm_inner", "lm_propose", "lm_decide", "span",
                                              "segment_objects")})
    if tag is not None:
        check_card_kernels(tag, out, out["tracker_updates"], out["covariance_calls"],
                           sum(hungarian.HOST_READS.values()), window)
        check(out["segment_objects"] == out["tracker_updates"],
              f"{tag}: segment_objects launched {out['segment_objects']} times for "
              f"{out['tracker_updates']} tracker updates")


def segment_cases(dev):
    """(name, args, kw) of ``tests/torch_segment_cases.py``'s cases on ``dev``."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import torch_segment_cases
    finally:
        sys.path.pop(0)
    out = []
    for name in torch_segment_cases.CASES:
        labels, ranges, pts, res, h, kw = torch_segment_cases.case(name)
        out.append((f"cpu_test_{name}", [torch.from_numpy(np.asarray(x)).to(dev)
                                         for x in (labels, ranges, pts, res, h)], kw))
    return out


def check_segment_objects(cases, tag, time_case=None):
    """``segmentation.segment_objects`` (the kernel) against
    ``segment_objects_plain`` on the card, every output as bits and the
    ``seg_roots`` each adds; one launch a call. Timed on ``cases[time_case]``
    (device ms of a call's operations, the kernel table's columns)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda, segmentation
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    off, launched, roots = [], [], []
    for name, a, kw in cases:
        before = nn_cuda.LAUNCHES["segment_objects"]
        with profiling.device_counts("cuda") as kc:
            got = segmentation.segment_objects(*a, **kw)
        launched.append(nn_cuda.LAUNCHES["segment_objects"] - before)
        with profiling.device_counts("cuda") as pc:
            plain = segmentation.segment_objects_plain(*a, **kw)
        same = all(x.dtype == y.dtype and x.shape == y.shape
                   and np.array_equal(x.cpu().numpy().view(np.uint8), y.cpu().numpy().view(np.uint8))
                   for x, y in zip(got, plain))
        roots.append(kc.get("seg_roots", 0))
        if not same or kc.get("seg_roots", 0) != pc.get("seg_roots", 0):
            off.append(name)
    rec = dict(kernel="segment_objects", case=tag, calls=len(cases), cases_not_bit_equal=off,
               launches_per_call=sorted(set(launched)), seg_roots=roots,
               max_abs_err=0.0 if not off else None, all_rows_identical=not off)
    if time_case is not None:
        _, a, kw = cases[time_case]
        n = a[0].numel()
        call = lambda: segmentation.segment_objects(*a, **kw)  # noqa: E731
        dev = device_times(call, KERNEL_NAMES["segment_objects"])
        call_ms = cuda_ms(call)
        timer = "profiler"
        if dev["ms"] is None:
            dev["ms"], timer = call_ms, "events"
        b, by = bound_ms(0, SEGMENT_BYTES_PER_PIXEL * n)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        ops = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((k for k in ("seg_count", "seg_select", "seg_stats", "seg_finish", "Memset")
                            if k in e.name), e.name[:40])
                ops[key].append((e.time_range.end - e.time_range.start) / 1e3)
        rec.update(timed=cases[time_case][0], pixels=n, candidates=kw.get("candidates"),
                   bound_ms=b, bound_by=by, timer=timer, call_ms=call_ms,
                   plain_ms=cuda_ms(lambda: segmentation.segment_objects_plain(*a, **kw), reps=5),
                   launch_floor_ms=launch_floor_ms(),
                   op_ms={k: statistics.median(v) for k, v in ops.items()}, **dev)
    print("kernel check " + json.dumps(rec), flush=True)
    check(not off, f"segment_objects {tag}: the kernel differs from its plain version on {off}")
    check(launched and set(launched) == {1}, f"segment_objects {tag}: {launched} launches a call")
    return rec


def check_span(cfg, seq, dev):
    """The stamp (``csrc/trace.cu`` ``ddlo_span``) against its plain
    version, ``profiling.mark`` on the CPU (the host clock): the bench
    step's graph replayed inside ``device_counts`` on the card and the
    same scans stepped on the CPU give every span the same ``.n`` and the
    same count of stamps (``span``); on the card the stage spans sum to
    no more than the graph's; with the gate off (after the block) a replay
    changes no span slot and no open time. Timed: one stamp with tracing
    on (device, call), its device time off, and the CPU stamp (plain).
    Each timed stamp is counted on the host and held to ``span``."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    def run(device):
        st = pipeline.init_state(cfg, seq.points[0], seq.mask[0], float(seq.stamps[0]), device=device)
        st, _ = pipeline.step(cfg, st, seq.points[1], seq.mask[1], float(seq.stamps[1]))  # the card's capture
        with profiling.device_counts(device) as got:
            for i in range(2, SPAN_SCANS):
                st, out = pipeline.step(cfg, st, seq.points[i], seq.mask[i], float(seq.stamps[i]))
                out.odom.T.cpu()
        return st, got

    st, card = run(dev)
    buf, opened = profiling.counts_buffer(dev), profiling._OPENED[str(dev)]
    slots = [i for k, i in profiling._SLOTS.items() if k.startswith("span")]
    before = buf[:, slots].clone(), opened.clone()
    pipeline.step(cfg, st, seq.points[SPAN_SCANS], seq.mask[SPAN_SCANS], float(seq.stamps[SPAN_SCANS]))
    torch.cuda.synchronize()
    gate_off_same = bool(torch.equal(buf[:, slots], before[0]) and torch.equal(opened, before[1]))
    pipeline.clear_graphs()  # the later phases capture their own
    _, host = run("cpu")

    steps = SPAN_SCANS - 2
    names = ("graph",) + profiling.STAGE_SPANS
    keys = sorted({k for k in (*card, *host) if k == "span" or (k.startswith("span.") and k.endswith(".n"))})
    differ = {k: (card.get(k, 0), host.get(k, 0)) for k in keys if card.get(k, 0) != host.get(k, 0)}
    stage_ns = sum(card.get(f"span.{n}.ns", 0) for n in profiling.STAGE_SPANS)

    made = [0]

    def call():
        made[0] += 1
        profiling.mark(dev, begin="smoke")

    with profiling.device_counts(dev) as timed:
        dev_on = device_times(call, KERNEL_NAMES["span"])
        call_ms = cuda_ms(call)
    made_on = made[0]
    dev_off = device_times(call, KERNEL_NAMES["span"])
    with profiling.device_counts("cpu"):
        t0 = time.perf_counter()
        for _ in range(1000):
            profiling.mark("cpu", begin="smoke")
        plain_ms = (time.perf_counter() - t0) / 1000 * 1e3
    timer = "profiler"
    if dev_on["ms"] is None:
        dev_on["ms"], timer = call_ms, "events"
    rec = dict(kernel="span", case=f"bench_step_{steps}_replays", max_abs_err=max(
        (abs(a - b) for a, b in differ.values()), default=0), counts_card={k: card.get(k, 0) for k in keys},
        counts_cpu={k: host.get(k, 0) for k in keys}, stage_ns=stage_ns, graph_ns=card.get("span.graph.ns", 0),
        gate_off_unchanged=gate_off_same, stamps_timed=made_on, stamps_counted=timed.get("span", 0),
        timer=timer, call_ms=call_ms, plain_ms=plain_ms, off_ms=dev_off["kernel_ms"],
        timed_bytes=SPAN_BYTES, bound_ms=SPAN_BYTES / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        launch_floor_ms=launch_floor_ms(),
        note="bound by latency: the launch floor, not bytes, sets the time", **dev_on)
    print("kernel check " + json.dumps(rec), flush=True)
    check(not differ, f"span: the card's stamps count otherwise than the CPU's: {differ}")
    check(all(card.get(f"span.{n}.n") == steps for n in names),
          f"span: not every span closed once a replay: {rec['counts_card']}")
    check(0 < stage_ns <= rec["graph_ns"], f"span: stages {stage_ns} ns against the graph's {rec['graph_ns']}")
    check(gate_off_same, "span: a replay with the gate off changed the span counts or open times")
    check(made_on == rec["stamps_counted"], f"span: {made_on} stamps made, {rec['stamps_counted']} counted")
    return rec


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
        lambda: nn_cuda.nn1_dense_chunks(q, tt, t_chunk),
        cuda_ms(lambda: nn_cuda.nn1_dense_reference(q, tt)),
        _cdist_tiles(q, tt.T.contiguous(), 1024, [None] * (q.shape[0] // 1024)),
    )


def check_classes(name, query, target, k, prune_radius=None, t_chunk=512, empty_tile=None):
    """The lane-class k-NN kernel (dense or pruned) against its plain
    version: every row identical, and two device operations per call
    (the kernel and its device count).
    ``empty_tile``: a query tile whose chunk list is emptied."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    Q, T, q_tile = query.shape[0], target.shape[0], 1024
    q = pad_rows(query, q_tile, 0.0).contiguous()
    t = pad_rows(target, t_chunk, 1.0e6)
    tt = t.T.contiguous()
    counts = lists = None
    if prune_radius is not None:
        counts, lists = nn_cuda.class_chunk_lists(q, t, prune_radius, q_tile, t_chunk)
        if empty_tile is not None:
            counts[empty_tile] = 0
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
    rec = _record(
        kernel, name, Q, T, err, same, pairs,
        (query.numel() + target.numel()) * 4 + 8 * Q * k,
        lambda: nn_cuda.knn_classes_chunks(*args),
        cuda_ms(lambda: nn_cuda.knn_classes_reference(*args)),
        _cdist_tiles(q, t, q_tile, cols, k=k), k=k, prune_radius=prune_radius, t_chunk=t_chunk,
    )
    # the kernel and the one-element add of its device count (utils.profiling.count)
    check(rec["device_ops_per_call"] in (2, "not measured"),
          f"{kernel} {name}: {rec['device_ops_per_call']} device operations per call {rec['device_op_names']}")
    return rec


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

    with main_path_counts("detection card") as counts:
        dg, sg, og = run("cuda")
    dc, sc, oc = run("cpu")
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
    return counts


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


def device_busy_ms(fn) -> tuple:
    """(busy ms, device operations) of ``fn`` on the card, under
    ``torch.profiler`` (CUPTI timestamps)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, ops = profiling.device_busy_us(prof)
    return busy / 1e3, ops


def sub_sequence(seq, n):
    from dynamic_direct_lidar_odometry_tpu_torch.io.dataset import ScanSequence

    return ScanSequence(points=seq.points[:n], mask=seq.mask[:n], stamps=seq.stamps[:n],
                        H=seq.H, W=seq.W, gt_poses=seq.gt_poses[:n])


@contextlib.contextmanager
def recorded(mod, names):
    """Count the calls of ``mod``'s functions ``names`` and keep each one's
    last arguments, without touching what they do."""
    rec = {n: dict(calls=0, args=None) for n in names}
    real = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def f(*a, **kw):
            rec[n]["calls"] += 1
            rec[n]["args"] = (a, kw)
            return real[n](*a, **kw)
        return f

    for n in names:
        setattr(mod, n, wrap(n))
    try:
        yield rec
    finally:
        for n in names:
            setattr(mod, n, real[n])


@contextlib.contextmanager
def recorded_calls(mod, name, clone=False):
    """Keep the (args, kwargs) of every call of ``mod.<name>`` in a list,
    without touching what it does (``clone``: copies of its positional
    tensors, which a later step may overwrite)."""
    import torch

    calls, real = [], getattr(mod, name)

    def f(*a, **kw):
        calls.append((tuple(x.clone() if clone and isinstance(x, torch.Tensor) else x for x in a), kw))
        return real(*a, **kw)

    setattr(mod, name, f)
    try:
        yield calls
    finally:
        setattr(mod, name, real)


def check_artifacts(out, res, cfg, n):
    """Phase 9: every file of the replay exists and parses."""
    from dynamic_direct_lidar_odometry_tpu_torch.io import pcd
    from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper

    steps = n - 1
    for name in ("trajectory_tum.txt", "trajectory_tum_00008.txt"):
        arr = np.loadtxt(os.path.join(out, name), ndmin=2)
        want = steps if name == "trajectory_tum.txt" else 8
        check(arr.shape == (want, 8) and np.all(np.isfinite(arr)), f"{name}: shape {arr.shape}")
    snap_pts, snap_mask = mapper.snapshot(res.map_state, cfg.map.leaf_size, 500_000)
    map_pts, _ = pcd.load_pcd(os.path.join(out, "map.pcd"))
    check(len(map_pts) == int(snap_mask.sum()) > 0,
          f"map.pcd holds {len(map_pts)} points, the snapshot {int(snap_mask.sum())}")
    check(np.array_equal(map_pts, snap_pts[snap_mask].cpu().numpy()), "map.pcd differs from the final snapshot")
    for name in ("map_00008.pcd", "clouds/00008_residuals.pcd", "clouds/00008_static.pcd",
                 "clouds/00008_keyframes.pcd"):
        pts, extra = pcd.load_pcd(os.path.join(out, name))
        check(len(pts) > 0 and np.all(np.isfinite(pts)), f"{name}: {len(pts)} points")
        if "residuals" in name:
            check("intensity" in extra, "the residual cloud has no intensity")
    with open(os.path.join(out, "tracks.jsonl")) as f:
        tracks = [json.loads(line) for line in f]
    check(len(tracks) > 0 and all(len(t["state"]) == 7 for t in tracks), "tracks.jsonl")
    sessions = [d for d in os.listdir(out) if os.path.isdir(os.path.join(out, d)) and d[:2] == "20"]
    check(len(sessions) == 1, f"evaluation sessions {sessions}")
    sess = os.path.join(out, sessions[0])
    with open(os.path.join(sess, "poses.txt")) as f:
        check(f.read().count(";") == steps, "poses.txt blocks")
    idx = []
    for i in range(1, n):
        with open(os.path.join(sess, "%04d.txt" % i)) as f:
            idx.append([int(v) for v in f.read().split()])
    check([len(a) for a in idx] == res.dynamic_counts.tolist(), "dynamic index files")
    check(os.path.exists(os.path.join(out, "ckpt_000008.npz")), "no checkpoint at scan 8")
    objs = [f for f in os.listdir(out) if f.startswith("object_traj_obj")]
    for f in objs:
        check(np.loadtxt(os.path.join(out, f), ndmin=2).shape[1] == 5, f)
    return dict(files=sorted(os.listdir(out)), tracks_records=len(tracks), object_trajectories=len(objs),
                map_pcd_points=len(map_pts))


def replay_phase(cfg, seq, ref, card):
    """Phase 9: ``runner.replay`` on the card, against the JAX CPU replay."""
    import tempfile

    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import runner
    from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper

    n = int(ref["n_scans"])
    sub = sub_sequence(seq, n)
    with tempfile.TemporaryDirectory() as out:
        with recorded(runner.mapper, ("add_keyframe", "remove_boxes", "snapshot")) as calls, \
                main_path_counts("replay", window=True) as card_launches:
            res = runner.replay(cfg, sub, out_dir=out, evaluate=True, checkpoint_every=8,
                                save_every=8, export_clouds_every=8)
        launches = card_launches["nn1_sparse"]
        files = check_artifacts(out, res, cfg, n)
        resumed = runner.replay(cfg, sub, resume_from=os.path.join(out, "ckpt_000008.npz"))
    div = float(np.linalg.norm(res.poses - ref["poses"], axis=1).max())
    resume_err = float(np.abs(resumed.poses - res.poses[-len(resumed.poses):]).max())
    dyn, dyn_jax = int(res.dynamic_counts.sum()), int(ref["dynamic_counts"].sum())

    # the map node's calls on the card at the replay's last inputs
    map_ms = {k: cuda_ms(lambda a=v["args"]: getattr(mapper, k)(*a[0], **a[1]), reps=10)
              for k, v in calls.items() if v["args"] is not None}
    # remove_boxes over every history box of the final tracks, card vs host
    trk = res.final_state.tracks
    boxes, valid = trk.bbox_hist, trk.active[:, None].expand(trk.bbox_hist.shape[:2])
    m_card = mapper.remove_boxes(res.map_state, boxes, valid, margin=cfg.map.filter_margin)
    host = type(res.map_state)(*(t.cpu() for t in res.map_state))
    m_host = mapper.remove_boxes(host, boxes.cpu(), valid.cpu(), margin=cfg.map.filter_margin)
    removed = int(res.map_state.mask.sum() - m_card.mask.sum())
    map_ms["remove_boxes_final_history"] = cuda_ms(
        lambda: mapper.remove_boxes(res.map_state, boxes, valid, margin=cfg.map.filter_margin), reps=10)
    # the replay alone (no artifacts), then its device busy time under the profiler
    bare = runner.replay(cfg, sub)
    repeat_err = float(np.abs(bare.poses - res.poses).max())
    busy, kernels = device_busy_ms(lambda: runner.replay(cfg, sub))
    tot, tot_bare = res.profiler["total"], bare.profiler["total"]
    rec = dict(
        scans=n, card=card, max_divergence_mm=div * 1e3,
        ate_port_mm=runner.ate_rmse(res.poses, sub.gt_poses) * 1e3, ate_jax_cpu_mm=float(ref["ate"]) * 1e3,
        keyframes=res.num_keyframes, keyframes_jax=int(ref["num_keyframes"]),
        map_points=res.map_points, map_points_jax=int(ref["map_points"]),
        dynamic_pixels=dyn, dynamic_pixels_jax=dyn_jax,
        scans_that_cleared_boxes=calls["remove_boxes"]["calls"],
        map_calls={k: v["calls"] for k, v in calls.items()}, map_ms_per_call=map_ms,
        total_ms_per_scan=dict(mean=tot_bare.mean, min=tot_bare.min, max=tot_bare.max, n=tot_bare.n),
        total_ms_per_scan_with_artifacts=dict(mean=tot.mean, min=tot.min, max=tot.max, n=tot.n),
        device_busy_ms_per_scan=busy / (n - 1), kernels_per_scan=kernels / (n - 1),
        device_idle_share=1.0 - busy / (n - 1) / tot_bare.mean,
        resume_max_abs_m=resume_err, repeat_max_abs_m=repeat_err,
        final_history_boxes=int(valid.sum()), points_in_boxes=removed,
        launches=card_launches, **files,
    )
    print("replay " + json.dumps(rec), flush=True)
    check(div <= DIVERGENCE_BAR_M, f"replay poses diverge {div * 1e3:.3f} mm from JAX")
    check(res.num_keyframes == int(ref["num_keyframes"]), "replay keyframe count differs from JAX")
    check(abs(res.map_points - int(ref["map_points"])) <= MAP_BAR * int(ref["map_points"]),
          f"{res.map_points} map points against {int(ref['map_points'])}")
    check(abs(dyn - dyn_jax) <= DYNAMIC_BAR * dyn_jax, f"{dyn} dynamic pixels against {dyn_jax}")
    check(len(resumed.poses) == n - 9 and resume_err <= RESUME_ATOL_M,
          f"resuming from scan 8 moved a pose by {resume_err} m")
    check(repeat_err <= RESUME_ATOL_M, f"a second replay moved a pose by {repeat_err} m")
    check(torch.equal(m_card.mask.cpu(), m_host.mask) and torch.equal(m_card.points.cpu(), m_host.points),
          "remove_boxes differs between the card and the host")
    check(launches >= 3 * (n - 1), f"nn1_sparse launched {launches} times in {n - 1} replayed scans")
    return launches, card_launches


def hull_stores(K):
    """K keyframe positions along a wandering planar trajectory (the
    replay's kind of store), all valid."""
    rng = np.random.default_rng(K)
    heading = np.cumsum(rng.normal(0, 0.4, K))
    steps = np.stack([np.cos(heading), np.sin(heading), rng.normal(0, 0.05, K)], 1)
    return (20.0 * np.cumsum(steps, 0) / K).astype(np.float32)


def cli_phase(seq, ref, card):
    """Phase 10: ``cli run`` at its own capacity, on the card."""
    import io
    import tempfile

    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import cli, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf
    from dynamic_direct_lidar_odometry_tpu_torch.utils import checkpoint, metrics

    n = int(ref["n_scans"])
    sub = sub_sequence(seq, n)
    cfg = cli.run_config(seq.H, seq.W)
    with tempfile.TemporaryDirectory() as d:
        path, out = os.path.join(d, "seq.npz"), os.path.join(d, "out")
        sub.save(path)
        args = ["run", "--dataset", path, "--out", out, "--quiet", "--checkpoint-every", str(n - 1)]
        kf.BLOCKED_CALLS.update(convex=0, concave=0)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), main_path_counts() as got:
            rc = cli.main(args)
        launches, blocked = got["nn1_sparse"], dict(kf.BLOCKED_CALLS)
        text = buf.getvalue()
        check(rc == 0, f"cli run returned {rc}")
        tum = np.loadtxt(os.path.join(out, "trajectory_tum.txt"), ndmin=2)
        like = (pipeline.init_state(cfg, sub.points[0], sub.mask[0]), mapper.empty_map(500_000))
        (state, _), meta = checkpoint.restore(os.path.join(out, f"ckpt_{n - 1:06d}.npz"), like)
        # the CLI without artifacts (warm), then its device busy time under the profiler
        bare = io.StringIO()
        with contextlib.redirect_stdout(bare):
            check(cli.main(["run", "--dataset", path, "--quiet"]) == 0, "cli run (bare) failed")
        with contextlib.redirect_stdout(io.StringIO()):
            busy, kernels = device_busy_ms(lambda: cli.main(["run", "--dataset", path, "--quiet"]))
    summary = re.search(r"scans=(\d+) keyframes=(\d+) map_points=(\d+)", text)
    ate = re.search(r"ATE RMSE vs ground truth: ([\d.]+) m", text)
    total_re = r"total: last +([\d.]+) +mean +([\d.]+) +var +[\d.]+ +min +([\d.]+) +max +([\d.]+)"
    total, total_bare = re.search(total_re, text), re.search(total_re, bare.getvalue())
    check(summary and ate and total and total_bare, f"cli run printed no summary: {text[-500:]}")
    keyframes = int(summary.group(2))
    ate_m = metrics.ate_rmse(tum[:, 1:4], sub.gt_poses, est_stamps=tum[:, 0], gt_stamps=sub.stamps)
    check(abs(ate_m - float(ate.group(1))) < 1e-4, f"cli run printed ATE {ate.group(1)}, the trajectory gives {ate_m}")
    div = float(np.linalg.norm(tum[:, 1:4] - ref["poses"], axis=1).max())

    # blocked hulls: the final store, and 128- and 256-keyframe stores
    store, dev = state.odom.store, state.odom.T.device
    hulls = {}
    for tag, pos, valid, alpha in [
        ("final_store", store.positions, store.valid, state.odom.keyframe_thresh_dist),
        *[(f"K{K}", torch.as_tensor(hull_stores(K), device=dev), torch.ones(K, dtype=torch.bool, device=dev),
           torch.tensor(1.0, device=dev)) for K in (128, 256)],
    ]:
        card_m = (kf.convex_hull_mask(pos, valid), kf.concave_hull_mask(pos, valid, alpha))
        host_m = (kf.convex_hull_mask(pos.cpu(), valid.cpu()),
                  kf.concave_hull_mask(pos.cpu(), valid.cpu(), alpha.cpu()))
        same = all(torch.equal(a.cpu(), b) for a, b in zip(card_m, host_m))
        hulls[tag] = dict(K=int(pos.shape[0]), valid=int(valid.sum()), convex=int(card_m[0].sum()),
                          concave=int(card_m[1].sum()), card_equals_host=same)
        if tag != "final_store":
            hulls[tag].update(convex_ms=cuda_ms(lambda: kf.convex_hull_mask(pos, valid), reps=10),
                              concave_ms=cuda_ms(lambda: kf.concave_hull_mask(pos, valid, alpha), reps=10))
        check(same, f"blocked hulls of {tag} differ between the card and the host")
    steps = int(summary.group(1))
    rec = dict(
        scans=n, card=card, max_divergence_mm=div * 1e3, ate_port_mm=ate_m * 1e3,
        ate_jax_cpu_mm=float(ref["ate"]) * 1e3, keyframes=keyframes, keyframes_jax=int(ref["num_keyframes"]),
        map_points=int(summary.group(3)), map_points_jax=int(ref["map_points"]),
        capacity=dict(max_keyframes=cfg.capacity.max_keyframes, max_points=cfg.capacity.max_points,
                      max_submap_points=cfg.capacity.max_submap_points),
        total_ms_per_scan={k: float(total_bare.group(i)) for k, i in (("mean", 2), ("min", 3), ("max", 4))},
        total_ms_per_scan_with_artifacts={k: float(total.group(i)) for k, i in (("mean", 2), ("min", 3), ("max", 4))},
        device_busy_ms_per_scan=busy / steps, kernels_per_scan=kernels / steps,
        device_idle_share=1.0 - busy / steps / float(total_bare.group(2)),
        blocked_hull_calls=blocked, hulls=hulls, launches=dict(nn1_sparse=launches),
    )
    print("cli " + json.dumps(rec), flush=True)
    check(cfg.capacity.max_keyframes > 64, "the CLI capacity does not take the blocked hulls")
    check(blocked["convex"] > 0 and blocked["concave"] > 0, f"the blocked hulls did not run: {blocked}")
    check(steps == n - 1 and tum.shape == (n - 1, 8), f"cli run replayed {steps} scans")
    check(div <= DIVERGENCE_BAR_M, f"cli run poses diverge {div * 1e3:.3f} mm from JAX")
    check(keyframes == int(ref["num_keyframes"]), "cli run keyframe count differs from JAX")
    check(ate_m < ATE_BAR_M, f"cli run ATE {ate_m} m")
    check(meta.get("next_scan") == n, f"last checkpoint meta {meta}")
    check(launches >= 3 * steps, f"nn1_sparse launched {launches} times in {steps} scans")
    return launches


def kantplatz_phase(card):
    """Phase 11: ``kantplatz_config()`` at 512 x 512 on the card."""
    import dataclasses

    from dynamic_direct_lidar_odometry_tpu_torch import config
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    ref = np.load(GOLDEN_KANTPLATZ)
    t0 = time.perf_counter()
    seq = sequence.kantplatz_sequence()
    n = len(seq)
    check(sequence.sequence_sha256(seq, n) == str(ref["scans_sha256"]),
          "the kantplatz scans differ from the reference sequence")
    cfg = dataclasses.replace(config.kantplatz_config(), capacity=config.capacity_for_scan(512, 512))
    render_s = time.perf_counter() - t0
    with main_path_counts("kantplatz") as card_launches:
        poses, steps = run_slice(cfg, seq.points, seq.mask, seq.stamps, "cuda", timed=True)
    launches = card_launches["nn1_sparse"]
    summary, div = slice_summary("kantplatz", poses, steps, ref, seq, n, card)
    busy, ops = device_busy_ms(lambda: run_slice(cfg, seq.points, seq.mask, seq.stamps, "cuda"))
    dets, jax_dets = [r["detections"] for r in steps], ref["detections"].tolist()
    mean_ms = statistics.mean(summary["step_ms"])
    summary.update(
        render_s=render_s, capacity=dict(max_points=cfg.capacity.max_points,
                                         max_submap_points=cfg.capacity.max_submap_points,
                                         max_keyframes=cfg.capacity.max_keyframes,
                                         max_keyframe_points=cfg.capacity.max_keyframe_points,
                                         max_objects=cfg.capacity.max_objects),
        window=[cfg.detection.window_row_min, cfg.detection.window_row_max,
                cfg.detection.window_col_min, cfg.detection.window_col_max],
        detections=dets, detections_jax=jax_dets,
        outside_window=[r["outside_window"] for r in steps],
        device_busy_ms_per_scan=busy / (n - 1), device_ops_per_scan=ops / (n - 1),
        device_idle_share=1.0 - busy / (n - 1) / mean_ms, mean_ms=mean_ms,
        launches=card_launches, labels_vs_reference=[r["labels_vs_reference"] for r in steps],
    )
    print("kantplatz " + json.dumps(summary), flush=True)
    check(div <= DIVERGENCE_BAR_M, f"kantplatz poses diverge {div * 1e3:.3f} mm from JAX")
    check(summary["keyframe_flags_match_jax"], "kantplatz keyframe flags differ from JAX")
    check(all(v == 0 for v in summary["outside_window"]), "kantplatz: a label outside the window")
    # the camera grid's labels are held to the plain reference (the port
    # departs from JAX there); a pixel may differ only in a component
    # that touches an edge whose angle lies within one float32 ulp of
    # theta (the card's atan2)
    check(all(r["labels_vs_reference"]["unexplained"] == 0 for r in steps),
          f"kantplatz: labels differ from the reference: {summary['labels_vs_reference']}")
    check(launches >= 3 * (n - 1), f"nn1_sparse launched {launches} times in {n - 1} scans")
    return launches, card_launches


def chunk_phase(cfg, seq, dev):
    """Phase 12: ``pipeline.step_chunk`` against the same steps one by one."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline

    K = CHUNK_K
    st0 = pipeline.init_state(cfg, seq.points[0], seq.mask[0], float(seq.stamps[0]), device=dev)
    pts = torch.as_tensor(seq.points[1 : K + 1], device=dev)
    msk = torch.as_tensor(seq.mask[1 : K + 1], device=dev)
    ts = torch.as_tensor(seq.stamps[1 : K + 1], dtype=torch.float32, device=dev)
    st, poses, added = st0, [], []
    for k in range(K):
        st, out = pipeline.step(cfg, st, pts[k], msk[k], ts[k])
        poses.append(out.odom.T)
        added.append(bool(out.keyframe_added))
    with main_path_counts() as got:
        st_c, outs = pipeline.step_chunk(cfg, st0, pts, msk, ts)  # captured at this call
    launches = got["nn1_sparse"]  # the one replay's: the capture's warm-up is not counted
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    pipeline.step_chunk(cfg, st0, pts, msk, ts)
    b.record()
    b.synchronize()
    err = float((outs.odom.T[:, :3, 3] - torch.stack(poses)[:, :3, 3]).abs().max())
    rec = dict(K=K, max_abs_m=err, chunk_ms_per_scan=a.elapsed_time(b) / K,
               keyframe_flags=outs.keyframe_added.tolist(), store_count=int(st_c.odom.store.count),
               launches=got)
    print("step_chunk " + json.dumps(rec), flush=True)
    check(err <= CHUNK_ATOL_M, f"step_chunk moved a pose by {err} m")
    check(outs.keyframe_added.tolist() == added, "step_chunk keyframe flags differ")
    check(int(st_c.odom.store.count) == int(st.odom.store.count), "step_chunk store count differs")
    check(tuple(outs.detections.labels.shape[:1]) == (K,), "step_chunk outputs not stacked")
    check(launches >= 3 * K, f"nn1_sparse launched {launches} times in {K} scans")
    return launches


@contextlib.contextmanager
def sync_free():
    """Raise on any synchronizing CUDA call in the block
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _loop_fn(x0, n, m):
    """A nested loop and a branch on the data (the LM's shape: an
    iteration loop around a trial loop), for :func:`check_set_cond`."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import control

    z = torch.zeros((), dtype=torch.int32, device=x0.device)
    x, i, tot = x0.clone(), z.clone(), z.clone()

    def outer(x, i, tot):
        j = torch.zeros((), dtype=torch.int32, device=x.device)

        def inner(x, j):
            x.copy_(torch.sin(x) * 1.25)
            j.add_(1)

        control.while_loop(lambda x, j: j < m + i, inner, (x, j))
        control.cond(x[0] > 0.5, lambda x: x.sub_(1.0), lambda x: x.mul_(0.5), (x,))
        i.add_(1)
        tot.add_(j)

    control.while_loop(lambda x, i, tot: i < n, outer, (x, i, tot))
    return x, i, tot


def _if_else_fn(x, c, f):
    """An IF / ELSE pair on a ``control.Test``, for :func:`check_set_cond`."""
    import torch_cond_cases as cc

    from dynamic_direct_lidar_odometry_tpu_torch.core import control

    y = x.clone()
    control.cond(control.Test(c, cc.LIMIT, all_of=(f,)), lambda y: y.mul_(2.0), lambda y: y.sub_(1.0), (y,))
    return y


def check_set_cond_tests(dev) -> dict:
    """The kernel's test (``control.Test``) against its plain evaluation:
    each output byte on ``tests/torch_cond_cases.py``'s grid; an IF / ELSE
    pair on a test captured once, replayed on every count and flag (one
    ``set_cond`` a replay on the device counts); CCL's 131,072-entry !=
    test launched twice in a row on one scratch, which the kernel leaves
    zeroed. Times: a one-flag test and the CCL-sized one (device, launched
    alone), with their bounds."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_cond_cases as cc

    from dynamic_direct_lidar_odometry_tpu_torch.core import control
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    grid = cc.grid()
    out = torch.zeros(len(grid), dtype=torch.bool, device=dev)
    plain = []
    for k, (_, *case) in enumerate(grid):
        test = cc.to_test(*case, device=dev)
        control.set_cond(test, out=out[k], scratch=control.scratch_for(test))
        plain.append(test.plain())
    want = torch.stack(plain).cpu()
    numpy_want = torch.tensor([cc.expected(*case) for _, *case in grid])
    grid_differ = [grid[k][0] for k in torch.nonzero(out.cpu() != want).reshape(-1).tolist()]
    plain_differ = int((want != numpy_want).sum())

    x = torch.arange(64, dtype=torch.float32, device=dev)
    graph, pair_differ, pair_sets = None, [], []
    for count in cc.COUNTS[1:]:
        for fv in (False, True):
            c = torch.tensor(count, dtype=torch.int32, device=dev)
            f = torch.tensor(fv, device=dev)
            graph = graph or control.Graph(_if_else_fn, (x, c, f))
            with profiling.device_counts(dev) as counts, sync_free():
                got = graph(x, c, f)
            pair_sets.append(counts.get("set_cond", 0))
            if not torch.equal(got, x * 2.0 if (count < cc.LIMIT and fv) else x - 1.0):
                pair_differ.append((count, fv))

    ccl_differ, scratch_left = [], 0
    for name, a, b in cc.ccl_sized():
        for count in cc.COUNTS:
            test = cc.to_test(count, (), (), (a, b), device=dev)
            scratch = control.scratch_for(test)
            outs = torch.zeros(2, dtype=torch.bool, device=dev)
            for r in range(2):
                control.set_cond(test, out=outs[r], scratch=scratch)
            if outs.tolist() != [cc.expected(count, (), (), (a, b))] * 2:
                ccl_differ.append((name, count))
            scratch_left += int(scratch.abs().sum())

    one = torch.ones((), dtype=torch.bool, device=dev)
    flag_test = control.Test(torch.zeros((), dtype=torch.int32, device=dev), 5, none_of=(~one, ~one))
    o = torch.zeros((), dtype=torch.bool, device=dev)
    _, a, b = cc.ccl_sized()[0]
    ccl_test = cc.to_test(None, (), (), (a, b), device=dev)
    ccl_scratch = control.scratch_for(ccl_test)
    flag_t = device_times(lambda: control.set_cond(flag_test, out=o), "set_cond_kernel")
    ccl_t = device_times(lambda: control.set_cond(ccl_test, out=o, scratch=ccl_scratch), "set_cond_kernel")
    return dict(
        grid_cases=len(grid), grid_cases_differ=grid_differ, grid_plain_vs_numpy_differ=plain_differ,
        if_else_replays=len(pair_sets), if_else_differ=pair_differ, if_else_set_cond_per_replay=pair_sets,
        ccl_sized_n=int(a.size), ccl_sized_launches=2 * len(cc.ccl_sized()) * len(cc.COUNTS),
        ccl_sized_differ=ccl_differ, ccl_scratch_left_nonzero=scratch_left,
        flag_test_kernel_ms=flag_t["kernel_ms"], flag_test_bound_ms=(1 + 1 + 4 + 1) / HBM_BYTES_PER_S * 1e3,
        ccl_test_kernel_ms=ccl_t["kernel_ms"], ccl_test_bound_ms=(8 * a.size + 1) / HBM_BYTES_PER_S * 1e3,
    )


def check_set_cond(dev):
    """The capture driver's kernel (``csrc/graph_cond.cu``
    ``ddlo_set_cond``) against its plain version, the eager driver's
    predicate read (``core/control.read_predicate``): a nested WHILE loop
    and an IF/ELSE branch captured once and replayed on several inputs
    (0 turns to 27), each replay under ``sync_free``; and the test forms
    of :func:`check_set_cond_tests`. ``max_abs_err``: the largest
    difference in the loops' turn counts and carried values, or the
    number of the tests' cases decided differently (0 = the same
    decisions). Times: the kernel's device time inside a replay
    (profiler), a replay's, and one eager predicate read (a host round
    trip, host clock), and the launch floor."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import control

    x0 = torch.linspace(-1.0, 1.0, 4096, device=dev)
    graph, err, turns, keep = None, 0.0, [], None
    for n_, m_ in ((0, 0), (1, 0), (3, 2), (6, 2)):
        nt = torch.full((), n_, dtype=torch.int32, device=dev)
        mt = torch.full((), m_, dtype=torch.int32, device=dev)
        ref = _loop_fn(x0, nt, mt)
        if graph is None:
            graph = control.Graph(_loop_fn, (x0, nt, mt))
            # allocated on the capturing thread after the capture: outside
            # the graph's pool, and untouched by the replays below
            keep = torch.full((1 << 16,), 7.0, device=dev)
            kept_out_of_pool = not control.in_pool(keep, graph.pool)
        torch.cuda.synchronize()
        with sync_free():
            out = graph(x0, nt, mt)
        torch.cuda.synchronize()
        err = max(err, float((out[0] - ref[0]).abs().max()), abs(int(out[1]) - int(ref[1])),
                  abs(int(out[2]) - int(ref[2])))
        turns.append(int(ref[2]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph(x0, nt, mt)
        torch.cuda.synchronize()
    sets = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "set_cond_kernel" in e.name]
    p = torch.ones((), dtype=torch.bool, device=dev)
    reads = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        control.read_predicate(p)
        reads.append((time.perf_counter() - t0) * 1e3)
    kept = kept_out_of_pool and bool((keep == 7.0).all())
    tests = check_set_cond_tests(dev)
    decided_differently = (len(tests["grid_cases_differ"]) + tests["grid_plain_vs_numpy_differ"]
                           + len(tests["if_else_differ"]) + len(tests["ccl_sized_differ"]))
    rec = dict(
        kernel="set_cond", case="nested_while_if_else", inner_turns=turns,
        max_abs_err=max(err, float(decided_differently)),
        allocation_after_capture_outside_pool_and_kept=kept,
        set_cond_per_replay=len(sets), timer="profiler",
        ms=statistics.median(sets) / 1e3 if sets else None,
        kernel_ms=statistics.median(sets) / 1e3 if sets else None,
        call_ms=cuda_ms(lambda: graph(x0, nt, mt)), replay_graph_nodes_note="one replay of the whole loop",
        plain_ms=statistics.median(reads), plain_timer="host clock, one predicate read",
        bound_ms=1 / HBM_BYTES_PER_S * 1e3, bound_by="bytes", launch_floor_ms=launch_floor_ms(),
        note="one byte read per launch: latency-bound", **tests,
    )
    print("kernel check " + json.dumps(rec), flush=True)
    check(err == 0.0, f"set_cond: the graph's loops decide differently from the eager driver ({err})")
    check(decided_differently == 0, f"set_cond: tests decided differently from the plain evaluation: {tests}")
    check(all(n == 1 for n in tests["if_else_set_cond_per_replay"]),
          f"set_cond: an IF / ELSE pair is not one launch: {tests['if_else_set_cond_per_replay']}")
    check(tests["ccl_scratch_left_nonzero"] == 0, "set_cond: the CCL-sized test left its scratch set")
    check(bool(sets), "set_cond: the profiler shows no ddlo_set_cond inside a replay")
    check(kept, "an allocation after the capture lies in the graph's pool or was overwritten")
    return rec


def _bits_differ(a, b) -> list:
    """Paths of the leaves of two containers that differ in any bit (NaN =
    NaN)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import tree

    out = []

    def walk(x, y, path):
        if x is None:
            return
        if tree.is_namedtuple(x):
            for f in x._fields:
                walk(getattr(x, f), getattr(y, f), f"{path}.{f}")
        elif isinstance(x, (tuple, list)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor):
            same = x.shape == y.shape and x.dtype == y.dtype and bool(
                ((x == y) | (x.isnan() & y.isnan()) if x.is_floating_point() else (x == y)).all())
            if not same:
                out.append(path)

    walk(a, b, "")
    return out


def profile_steps(cfg, step, st, pts, msk, ts, k0=1, k=8) -> tuple:
    """Scans k0 + 1 .. k0 + k through ``step`` from the state ``st`` under
    ``torch.profiler``: (per-scan busy ms, device operations, host launch
    calls and the hand-written kernels by the profiler's names; device
    operations per scan by name)."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(k0 + 1, k0 + 1 + k):
            st, _ = step(cfg, st, pts[i], msk[i], ts[i])
        torch.cuda.synchronize()
    busy, ops = profiling.device_busy_us(prof)
    events = profiling.device_events(prof)
    names = collections.Counter(e.name for e in events)
    api = collections.Counter(e.name for e in prof.events()
                              if e.name in ("cudaLaunchKernel", "cudaGraphLaunch", "cuLaunchKernel",
                                            "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    set_us = [e.time_range.end - e.time_range.start for e in events if "set_cond_kernel" in e.name]

    def per_scan(pat):
        return sum(v for nm, v in names.items() if pat in nm) / k

    return dict(
        device_busy_ms_per_scan=busy / 1e3 / k,
        device_ops_per_scan=ops / k, host_launch_calls_per_scan={a: v / k for a, v in api.items()},
        nn1_sparse_per_scan=per_scan("nn1_kernel<false>"), jv_solve_per_scan=per_scan("jv_solve_kernel"),
        plane_reg_per_scan=per_scan("plane_reg_kernel"), window_cov_per_scan=per_scan("window_cov_kernel"),
        set_cond_per_scan=len(set_us) / k,
        set_cond_us_mean=statistics.mean(set_us) if set_us else None,
    ), {nm: v / k for nm, v in names.items()}


def graph_names_phase(cfg, seq) -> dict:
    """Phase 17's profiler check, in a process that has captured no other
    graph: one ``cudaGraphLaunch`` per ``pipeline.step`` and, by the
    profiler's names, ``nn1_sparse``, ``jv_solve``, ``window_plane_cov``
    (and no ``regularize_plane``) and ``set_cond`` inside the replays of
    scans 2-9. Returns the device
    operations per scan by name, which the later graph phase compares
    with its own."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline

    dev = torch.device("cuda", 0)
    pts = [torch.as_tensor(seq.points[i], device=dev) for i in range(10)]
    msk = [torch.as_tensor(seq.mask[i], device=dev) for i in range(10)]
    ts = [torch.full((), float(seq.stamps[i]), dtype=torch.float32, device=dev) for i in range(10)]
    pipeline.clear_graphs()
    st = pipeline.init_state(cfg, seq.points[0], seq.mask[0], float(seq.stamps[0]), device=dev)
    st, _ = pipeline.step(cfg, st, pts[1], msk[1], ts[1])  # captures
    prof, names = profile_steps(cfg, pipeline.step, st, pts, msk, ts)
    pipeline.clear_graphs()  # later phases capture their own
    print("graph names " + json.dumps(dict(profile=prof, device_ops_per_scan_by_name=names)), flush=True)
    check(prof["nn1_sparse_per_scan"] >= 3 and prof["jv_solve_per_scan"] >= 1
          and prof["window_cov_per_scan"] >= 1 and prof["plane_reg_per_scan"] == 0
          and prof["set_cond_per_scan"] >= 1,
          f"the kernels did not run inside the replays: {prof}")
    check(prof["host_launch_calls_per_scan"].get("cudaGraphLaunch", 0) == 1,
          f"a graph step is not one graph launch: {prof['host_launch_calls_per_scan']}")
    return names


def graph_phase(cfg, seq, card, fresh_names=None):
    """Phase 17: ``pipeline.step`` as a captured graph against
    ``pipeline.step_eager`` over bench scans 1-16."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline, runner
    from dynamic_direct_lidar_odometry_tpu_torch.core import control, tree
    from dynamic_direct_lidar_odometry_tpu_torch.io.dataset import ScanSequence
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, segmentation
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    n = GRAPH_SCANS
    pts = [torch.as_tensor(seq.points[i], device=dev) for i in range(n + 1)]
    msk = [torch.as_tensor(seq.mask[i], device=dev) for i in range(n + 1)]
    ts = [torch.full((), float(seq.stamps[i]), dtype=torch.float32, device=dev) for i in range(n + 1)]

    def run(step, guard=False):
        """init on scan 0, then scans 1-n; per scan the host clock around a
        synchronized step. ``guard``: every step after the first (the
        capture) under ``sync_free``."""
        st = pipeline.init_state(cfg, seq.points[0], seq.mask[0], float(seq.stamps[0]), device=dev)
        outs, states, ms = [], [], []
        for i in range(1, n + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sync_free() if guard and i > 1 else contextlib.nullcontext():
                st, out = step(cfg, st, pts[i], msk[i], ts[i])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
            states.append(st)
        return outs, states, ms

    # the graph run, counted on the device; replays under sync_free. The
    # graph is captured afresh (its capture seconds and pool are reported)
    pipeline.clear_graphs()
    reads0 = (sum(control.PREDICATE_READS.values()), segmentation.SWEEPS["host_reads"])
    with main_path_counts("graph", window=True) as counted:
        g_outs, g_states, g_ms = run(pipeline.step, guard=True)
        stats = pipeline.graph_stats()
    e_outs, e_states, e_ms = run(pipeline.step_eager)
    differ = {}
    for k in range(n):
        d = _bits_differ((g_states[k], g_outs[k]), (e_states[k], e_outs[k]))
        if d:
            differ[k + 1] = d
    gated = [p for ps in differ.values() for p in ps
             if p.startswith(("[1].odom.T", "[1].odom.pose", "[1].odom.rotq", "[1].keyframe_added",
                              "[1].detections", "[0].tracks", "[1].tracks"))]

    # per-scan wall, eager / graph / graph / eager (the graph's first call captures)
    walls = {"eager": [], "graph": []}
    for kind in ("eager", "graph", "graph", "eager"):
        walls[kind] += run(pipeline.step if kind == "graph" else pipeline.step_eager)[2][1:]
    wall = {k: statistics.median(v) for k, v in walls.items()}

    (prof_graph, names), (prof_eager, _) = (profile_steps(cfg, step, e_states[0], pts, msk, ts)
                                            for step in (pipeline.step, pipeline.step_eager))
    if fresh_names is not None:
        # the profiler's names here, after the other phases' graphs, against
        # those of the same replays before any other capture (graph_names_phase)
        prof_graph["names_differ_from_first_capture"] = {
            nm: [fresh_names.get(nm, 0.0), names.get(nm, 0.0)] for nm in sorted(set(names) | set(fresh_names))
            if fresh_names.get(nm, 0.0) != names.get(nm, 0.0)}
    for kind, pr in (("graph", prof_graph), ("eager", prof_eager)):
        pr["device_idle_share"] = 1.0 - pr["device_busy_ms_per_scan"] / wall[kind]

    # step_chunk at K = CHUNK_K: one graph, one launch per chunk, equal to the graph steps
    st0 = pipeline.init_state(cfg, seq.points[0], seq.mask[0], float(seq.stamps[0]), device=dev)
    K = CHUNK_K
    cp, cm = torch.stack(pts[1:K + 1]), torch.stack(msk[1:K + 1])
    cts = torch.stack(ts[1:K + 1])
    st_c, outs_c = pipeline.step_chunk(cfg, st0, cp, cm, cts)  # captured here
    chunk_differ = _bits_differ((st_c, outs_c), (g_states[K - 1], tree.stack(g_outs[:K])))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with sync_free():
            pipeline.step_chunk(cfg, st0, cp, cm, cts)
        torch.cuda.synchronize()
    graph_launches = sum(1 for e in prof.events() if e.name == "cudaGraphLaunch")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    chunk_ms = []
    for _ in range(3):
        a.record()
        pipeline.step_chunk(cfg, st0, cp, cm, cts)
        b.record()
        b.synchronize()
        chunk_ms.append(a.elapsed_time(b) / K)

    # the runner's watchdog on the graph path: a poisoned pose rolls back to
    # the state before it, which a later replay must not have overwritten;
    # the run equals a replay of the sequence without that scan
    m, bad = WATCHDOG_SCANS, 3
    sub = sub_sequence(seq, m)
    real_step, calls = runner.pipeline.step, {"n": 0}

    def poisoned(cfg_, state, p, mk, t, hull_masks=None, **kw):
        calls["n"] += 1
        state2, out = real_step(cfg_, state, p, mk, t, hull_masks, **kw)
        if calls["n"] == bad:
            T = out.odom.T.clone()
            T[0, 3] = float("nan")
            out = out._replace(odom=out.odom._replace(T=T))
        return state2, out

    runner.pipeline.step = poisoned
    try:
        res_w = runner.replay(cfg, sub)
    finally:
        runner.pipeline.step = real_step
    keep = [i for i in range(m) if i != bad]
    res_r = runner.replay(cfg, ScanSequence(points=sub.points[keep], mask=sub.mask[keep],
                                            stamps=sub.stamps[keep], H=sub.H, W=sub.W,
                                            gt_poses=sub.gt_poses[keep]))
    watchdog_equal = bool(np.array_equal(res_w.poses, res_r.poses))

    host_reads = (sum(control.PREDICATE_READS.values()) - reads0[0],
                  segmentation.SWEEPS["host_reads"] - reads0[1])
    rec = dict(
        card=card, scans=n, graph_vs_eager_bits_differ=differ, gated_fields_differ=gated,
        wall_ms_per_scan=wall, wall_ms_first_graph_call=g_ms[0], wall_ms_per_scan_runs=walls,
        profile_graph=prof_graph, profile_eager=prof_eager,
        graphs=stats, launches=counted, jv_host_reads=sum(hungarian.HOST_READS.values()),
        predicate_and_ccl_reads_incl_warmup=host_reads,
        chunk=dict(K=K, bits_differ=chunk_differ, graph_launches_per_chunk=graph_launches,
                   ms_per_scan=chunk_ms),
        watchdog=dict(scans=m, dropped=res_w.dropped_scans, poses_equal_without_the_scan=watchdog_equal,
                      steps_called=calls["n"]),
    )
    print("graph " + json.dumps(rec), flush=True)
    check(not gated, f"graph step differs from step_eager in {gated}")
    # the kernels inside the replays, on the device counts (the profiler's
    # names are checked before any other capture: graph_names_phase)
    check(counted["nn1_sparse"] >= 3 * n and counted["jv_solve"] >= n and counted["window_plane_cov"] >= n
          and counted["set_cond"] >= n and counted["lm_inner"] >= n
          and counted["lm_propose"] == counted["lm_decide"] == 0,
          f"the kernels did not run inside the replays: {counted}")
    check(prof_graph["host_launch_calls_per_scan"].get("cudaGraphLaunch", 0) == 1,
          f"a graph step is not one graph launch: {prof_graph['host_launch_calls_per_scan']}")
    check(not chunk_differ, f"step_chunk differs from the graph steps in {chunk_differ}")
    check(graph_launches == 1, f"step_chunk made {graph_launches} graph launches")
    check(res_w.dropped_scans == 1 and watchdog_equal and calls["n"] == m,
          f"the watchdog on the graph path: {rec['watchdog']}")
    return rec


@contextlib.contextmanager
def s2m_calls(keep: int):
    """Record the arguments of the last ``keep`` S2M ``gicp.align`` calls
    (those exporting residuals) while the pipeline runs."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    calls, real = [], gicp.align

    def align(*a, **kw):
        settings = a[7] if len(a) > 7 else kw.get("settings")
        if settings is not None and settings.compute_residuals:
            calls.append((a[:7], settings))
            del calls[:-keep]
        return real(*a, **kw)

    gicp.align = align
    try:
        yield calls
    finally:
        gicp.align = real


def align_problems(calls):
    """Phase 5's last 8 S2M registrations, each guess moved by
    (0.03 (b + 1), -0.02 b, 0) m and turned by 0.005 b rad (every stream
    starts off its optimum by its own amount), stacked; with the settings
    and the 8 single-stream ``gicp.align`` results on the card."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    check(len(calls) == ALIGN_B, f"phase 5 recorded {len(calls)} S2M registrations")
    settings = calls[0][1]
    moved = []
    for b, (args, _) in enumerate(calls):
        th = 0.005 * b
        d = torch.eye(4, device=args[6].device)
        d[:2, :2] = torch.tensor([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        d[:3, 3] = torch.tensor([0.03 * (b + 1), -0.02 * b, 0.0])
        moved.append(args[:6] + (d @ args[6],))
    batch = [torch.stack([m[i] for m in moved]) for i in range(7)]
    return batch, settings, [gicp.align(*m, settings) for m in moved]


def batched_align_phase(problems, card):
    """Phase 13: ``batched_align`` of phase 5's last 8 S2M registrations
    on the card, a graph replay, against the eager ``gicp.align_batch``
    (bit for bit) and 8 single-stream aligns."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import se3
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, nn_cuda
    from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    batch, settings, singles = problems
    calls = [(tuple(x[b] for x in batch), settings) for b in range(ALIGN_B)]
    sharding.clear_graphs()
    aligner = sharding.batched_align(sharding.make_mesh(), settings)
    with recorded_trials() as trials:
        eager = gicp.align_batch(*batch, settings)
    aligner(*batch)  # the warm-up and the capture
    torch.cuda.synchronize()
    with profiling.device_counts("cuda") as got:
        with sync_free():
            res = aligner(*batch)
    got = dict(got)
    PATH_LAUNCHES.update({k: got.get(k, 0) for k in ("lm_inner", "lm_propose", "lm_decide")})
    differ = _bits_differ(res, eager)
    iters = res.iterations.tolist()
    lin = max(iters) + (1 if settings.compute_residuals else 0)
    t_err = max(float((res.T[b, :3, 3] - s.T[:3, 3]).abs().max()) for b, s in enumerate(singles))
    r_err = max(rot_err(res.T[b, :3, :3].cpu(), s.T[:3, :3].cpu()) for b, s in enumerate(singles))

    def per_s(B, fn):
        args = [x[:B] for x in batch]
        return B / (cuda_ms(lambda: fn(*args), reps=5) / 1e3)

    # graphs at B = 1 and B = ALIGN_B (each captured at its first call,
    # which cuda_ms's warm-up makes), against the eager call, in turns
    rates = {}
    for kind in ("eager", "graph", "graph", "eager"):
        fn = aligner if kind == "graph" else (lambda *a: gicp.align_batch(*a, settings))
        for B in (1, ALIGN_B):
            rates.setdefault(f"{kind}_b{B}", []).append(per_s(B, fn))
    single_ms = cuda_ms(lambda: [gicp.align(*c[0], settings) for c in calls], reps=3) / ALIGN_B
    # the batched entry at the final poses: device time against B x the single call's bound
    src_t = torch.where(batch[1][..., None], se3.transform_points(res.T, batch[0]), 1.0e6)
    tgt_q = torch.where(batch[4][..., None], batch[3], 1.0e6)
    prep = nn_cuda.prepare_sparse_targets(tgt_q)
    r = settings.max_correspondence_distance
    dev_t = device_times(lambda: nn_cuda.nn1_sparse_batched_prepared(src_t, prep, r), "nn1_kernel")
    q = nn_cuda._pad_dim1(src_t, 1024, 1.0e6)
    counts = nn_cuda._tile_overlap(q, prep.t_lo, prep.t_hi, r, 1024).sum()
    b_ms, b_by = bound_ms(float(counts) * 1024 * 512, (q.numel() + prep.tt.numel()) * 4 + 8 * q.shape[0] * q.shape[1])
    rec = dict(
        B=ALIGN_B, card=card, graph_vs_eager_bits_differ=differ,
        iterations=iters, single_iterations=[int(s.iterations) for s in singles],
        inliers=res.num_inliers.tolist(), single_inliers=[int(s.num_inliers) for s in singles],
        translation_max_abs_m=t_err, rotation_max=r_err, launches=got, batched_linearizations=lin,
        registrations_per_s={k: statistics.median(v) for k, v in rates.items()},
        registrations_per_s_runs=rates, registrations_per_s_single_loop=1e3 / single_ms,
        graphs=sharding.graph_stats(),
        batched_entry_ms=dev_t["ms"], batched_entry_kernel_ms=dev_t["kernel_ms"],
        batched_entry_bound_ms=b_ms, batched_entry_bound_by=b_by,
    )
    print("batched_align " + json.dumps(rec), flush=True)
    check(not differ, f"batched_align's graph differs from the eager align_batch in {differ}")
    check(iters == rec["single_iterations"], "batched_align iterations differ from single aligns")
    check(rec["inliers"] == rec["single_inliers"], "batched_align inliers differ from single aligns")
    check(t_err <= BATCH_T_ATOL_M and r_err <= BATCH_R_ATOL,
          f"batched_align differs from single aligns by {t_err} m, {r_err} rad")
    check(got.get("nn1_sparse_batched", 0) == lin and got.get("nn1_sparse", 0) == 0,
          f"a batched_align replay launched {got} for {lin} batched linearizations")
    check_trial_launches("batched_align", got, trials)
    return got.get("nn1_sparse_batched", 0)


def replay_batch_phase(cfg, seq, card):
    """Phase 14: ``replay_batch`` of 4 streams x 8 scans, and the batched
    step under it (one graph, a branch per stream), against each stream
    run alone through ``pipeline.step``'s graph on the card."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.core import tree
    from dynamic_direct_lidar_odometry_tpu_torch.parallel import replay, sharding
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    mesh = sharding.make_mesh()

    def streams(starts, n):
        sl = [slice(s0, s0 + n) for s0 in starts]
        return (np.stack([seq.points[s] for s in sl]), np.stack([seq.mask[s] for s in sl]),
                np.stack([seq.stamps[s] for s in sl]).astype(np.float32))

    def on_card(x):
        return torch.as_tensor(x, device=dev)

    def run(starts, n):
        """ms per stream scan of the batched step over scans 1..n-1 of the
        streams from their init, between CUDA events, once the step's
        graph exists."""
        p, m, t = streams(starts, n)
        st = sharding.batched_init_state(cfg, p[:, 0], m[:, 0], t[:, 0], device=dev)
        p, m, t = on_card(p), on_card(m), on_card(t)
        step(st, p[:, 1], m[:, 1], t[:, 1])  # the graph, captured if new
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for k in range(1, n):
            st, _ = step(st, p[:, k], m[:, k], t[:, k])
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / (len(starts) * (n - 1))

    starts = [STREAM_SCANS * b for b in range(STREAMS)]
    sharding.clear_graphs()
    p, m, t = streams(starts, STREAM_SCANS)
    t0 = time.perf_counter()
    res = replay.replay_batch(cfg, p, m, t)  # captures the B = 4 graph
    first_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = replay.replay_batch(cfg, p, m, t)
    replay_ms = (time.perf_counter() - t0) * 1e3 / (STREAMS * (STREAM_SCANS - 1))

    # the batched step (the graph replay_batch captured), counted on the
    # device, every replay sync-free
    step = sharding.batched_pipeline_step(cfg, mesh)
    st0 = sharding.batched_init_state(cfg, p[:, 0], m[:, 0], t[:, 0], device=dev)
    pd, md, td = on_card(p), on_card(m), on_card(t)
    batched, st = [], st0
    with main_path_counts("replay_batch", window=True) as counted:
        for k in range(1, STREAM_SCANS):
            with sync_free():
                st, out = step(st, pd[:, k], md[:, k], td[:, k])
            batched.append((st, out))
    # each stream alone through pipeline.step's graph: every leaf, every scan
    differ = {}
    for b in range(STREAMS):
        one = pipeline.init_state(cfg, p[b, 0], m[b, 0], float(t[b, 0]), device=dev)
        for k in range(1, STREAM_SCANS):
            one, out = pipeline.step(cfg, one, pd[b, k], md[b, k], td[b, k])
            d = _bits_differ((one, out), (tree.index(batched[k - 1][0], b),
                                          tree.index(batched[k - 1][1], b)))
            if d:
                differ[f"stream {b} scan {k}"] = d
    final_equal = all(
        _digest(tree.index(batched[-1][0], b)) == _digest(tree.index(res.final_states, b))
        for b in range(STREAMS))
    poses = torch.stack([o.odom.pose for _, o in batched], dim=1).cpu().numpy()

    def profiled(fn, st, n):
        """Per step of ``st = fn(st, k)[0]`` over scans 1..n (one profiler
        session): graph launches, device busy ms (the union of the device
        operations' intervals), the operations' summed ms (above busy
        where branches overlap) and the span from the first operation to
        the last."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for k in range(1, n + 1):
                st = fn(st, k)[0]
            torch.cuda.synchronize()
        dev_ev = [e.time_range for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return dict(graph_launches=sum(1 for e in prof.events() if e.name == "cudaGraphLaunch") / n,
                    busy_ms=profiling.device_busy_us(prof)[0] / 1e3 / n,
                    summed_ms=sum(r.end - r.start for r in dev_ev) / 1e3 / n,
                    span_ms=(max(r.end for r in dev_ev) - min(r.start for r in dev_ev)) / 1e3 / n)

    # one graph launch per B-stream step; device busy against the wall
    n = STREAM_SCANS - 1
    prof_b4 = profiled(lambda st, k: step(st, pd[:, k], md[:, k], td[:, k]), st0, n)
    one0 = pipeline.init_state(cfg, p[0, 0], m[0, 0], float(t[0, 0]), device=dev)
    prof_single = profiled(lambda st, k: pipeline.step(cfg, st, pd[0, k], md[0, k], td[0, k]), one0, n)
    launches = prof_b4["graph_launches"]

    # ms per stream scan: B = 1, 4 and 8 (B = 8 over scans 1-4), the
    # single graph step, and the streams in turn through step_eager (the
    # host-driven form of the batched step), in turns
    timings = collections.defaultdict(list)
    for rnd in range(2):
        timings["b4"].append(run(starts, STREAM_SCANS))
        timings["b1"].append(run(starts[:1], STREAM_SCANS))
        one = pipeline.init_state(cfg, p[0, 0], m[0, 0], float(t[0, 0]), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(1, STREAM_SCANS):
            one, _ = pipeline.step(cfg, one, pd[0, k], md[0, k], td[0, k])
        torch.cuda.synchronize()
        timings["single_graph_step"].append((time.perf_counter() - t0) * 1e3 / (STREAM_SCANS - 1))
        if rnd == 0:
            sts = [tree.index(st0, b) for b in range(STREAMS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(1, STREAM_SCANS):
                sts = [pipeline.step_eager(cfg, sts[b], pd[b, k], md[b, k], td[b, k])[0]
                       for b in range(STREAMS)]
            torch.cuda.synchronize()
            timings["eager_streams_in_turn"].append(
                (time.perf_counter() - t0) * 1e3 / (STREAMS * (STREAM_SCANS - 1)))
    for _ in range(2):
        timings["b8"].append(run([STREAM_SCANS * b for b in range(8)], 5))
    wall_b4 = statistics.median(timings["b4"]) * STREAMS
    rec = dict(
        streams=STREAMS, scans=STREAM_SCANS, starts=starts, card=card,
        bits_differ_from_single_graph_steps=differ, final_states_equal_replay_batch=final_equal,
        ms_per_stream_scan={k: statistics.median(v) for k, v in timings.items()},
        ms_per_stream_scan_runs=dict(timings), replay_batch_ms_per_stream_scan=replay_ms,
        replay_batch_first_call_s=first_wall, graph_launches_per_step=launches,
        profile_b4_per_step=prof_b4, profile_single_graph_step=prof_single,
        device_idle_share_b4_unprofiled_wall=1.0 - prof_b4["busy_ms"] / wall_b4,
        device_idle_share_b4_profiled_span=1.0 - prof_b4["busy_ms"] / prof_b4["span_ms"],
        graphs=sharding.graph_stats(), launches=counted,
        num_keyframes=res.num_keyframes.tolist(),
    )
    print("replay_batch " + json.dumps(rec), flush=True)
    n_steps = STREAMS * (STREAM_SCANS - 1)
    check(res.poses.shape == (STREAMS, STREAM_SCANS - 1, 3), f"replay_batch poses {res.poses.shape}")
    check(not differ, f"the batched step differs from single graph steps: {differ}")
    check(np.array_equal(res.poses, poses) and final_equal,
          "replay_batch differs from the batched step it runs")
    check(launches == 1, f"a batched step made {launches} graph launches")
    check(counted["tracker_updates"] == n_steps and counted["nn1_sparse"] >= 3 * n_steps,
          f"the batched step's device counts: {counted}")
    return counted["nn1_sparse"]


def _digest(tree) -> str:
    """sha256 over every tensor leaf of a container, in field order."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())

    walk(tree)
    return h.hexdigest()


def pt_rank(rank: int, port: int, data_path: str, out_dir: str) -> None:
    """One rank of phase 15, in a spawned process: a gloo group of PT
    ranks on the one card. (a) ``batched_align(point_sharded=True)`` of
    phase 13's problems; (b) ``point_parallel_pipeline_step`` over scans
    1..PT_SCANS. Writes ``rank<r>.json``; any failure exits non-zero."""
    import torch

    import dynamic_direct_lidar_odometry_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from dynamic_direct_lidar_odometry_tpu_torch import config
    from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, hungarian, nn_cuda
    from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed, sharding
    from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker

    torch.cuda.set_device(0)
    distributed.initialize(f"127.0.0.1:{port}", PT, rank, backend="gloo")
    nn_cuda.build()
    data = torch.load(data_path, weights_only=False)
    dev = torch.device("cuda", 0)
    mesh = sharding.make_mesh(PT, pt=PT)
    out = dict(rank=rank)

    # (a) point-sharded batched_align
    batch = [x.to(dev) for x in data["batch"]]
    aligner = sharding.batched_align(mesh, data["settings"], point_sharded=True)
    nn_cuda.LAUNCHES.clear()
    res = aligner(*batch)
    torch.cuda.synchronize()
    out["align"] = dict(
        T=res.T.cpu().numpy().tolist(), iterations=res.iterations.tolist(),
        inliers=res.num_inliers.tolist(), launches=dict(nn_cuda.LAUNCHES),
        ms_per_registration=cuda_ms(lambda: aligner(*batch), reps=3) / len(res.iterations),
        digest=_digest(res),
    )

    # (b) the point-parallel pipeline step over the bench scans
    cfg = config.bench_config()
    pts, msk, ts = data["points"], data["masks"], data["stamps"]
    states = sharding.batched_init_state(cfg, pts[:1], msk[:1], ts[:1], device=dev)
    step = sharding.point_parallel_pipeline_step(cfg, mesh)
    scans = []
    for i in range(1, len(pts)):
        nn_cuda.LAUNCHES.clear()
        hungarian.HOST_READS.clear()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with recorded(tracker, ("update",)) as upd, recorded(covariance, ("plane_covariances",)) as cov:
            a.record()
            states, outs = step(states, pts[i:i + 1], msk[i:i + 1], ts[i:i + 1])
            b.record()
            b.synchronize()
        scans.append(dict(
            ms=a.elapsed_time(b), launches=dict(nn_cuda.LAUNCHES),
            tracker_updates=upd["update"]["calls"], covariance_calls=cov["plane_covariances"]["calls"],
            jv_host_reads=sum(hungarian.HOST_READS.values()),
            linearizations=int(outs.odom.s2s_iterations[0]) + int(outs.odom.s2m_iterations[0]) + 1,
            s2m_converged=bool(outs.odom.s2m_converged[0]),
            keyframe_added=bool(outs.keyframe_added[0]), T=outs.odom.T[0].cpu().numpy().tolist(),
            residuals_len=int(outs.odom.residuals.shape[1]),
            state_digest=_digest(states), output_digest=_digest(outs),
        ))
    out["pipeline"] = scans
    # the per-scan rank agreement check alone (a collective: both ranks
    # time the same calls)
    from dynamic_direct_lidar_odometry_tpu_torch.core import tree

    one = tree.index(states, 0)
    out["check_agree_ms"] = cuda_ms(lambda: distributed.check_agree(one, mesh.pt_group), reps=5)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def point_parallel_phase(problems, seq, ref, card):
    """Phase 15: PT ranks (spawned processes, gloo) on the one card:
    ``batched_align(point_sharded=True)`` of phase 13's problems against
    the single aligns, and ``point_parallel_pipeline_step`` over
    ``bench_config()`` scans 1..PT_SCANS against the JAX CPU golden.
    Returns the launches of both ranks, summed: {kernel: n}."""
    import multiprocessing as mp
    import socket
    import tempfile

    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import config

    n_points = config.bench_config().capacity.max_points
    batch, settings, singles = problems
    with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        data_path = os.path.join(tmp, "inputs.pt")
        m = PT_SCANS + 1
        torch.save(dict(batch=[x.cpu() for x in batch], settings=settings,
                        points=seq.points[:m], masks=seq.mask[:m],
                        stamps=seq.stamps[:m].astype(np.float32)), data_path)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=pt_rank, args=(r, port, data_path, tmp)) for r in range(PT)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, PT_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * PT, f"point-parallel ranks exited {codes}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(PT)]

    # (a) against the single aligns
    al = ranks[0]["align"]
    T = np.array(al["T"])
    t_err = max(float(np.abs(T[b, :3, 3] - s.T[:3, 3].cpu().numpy()).max()) for b, s in enumerate(singles))
    r_err = max(rot_err(T[b, :3, :3], s.T[:3, :3].cpu().numpy()) for b, s in enumerate(singles))
    lin = max(al["iterations"]) + (1 if settings.compute_residuals else 0)
    # (b) against the golden
    pl = ranks[0]["pipeline"]
    poses = np.array([r["T"] for r in pl])
    div = float(np.linalg.norm(poses[:, :3, 3] - ref["poses"][1:PT_SCANS + 1, :3, 3], axis=1).max())
    flags = [r["keyframe_added"] for r in pl]
    ms = [r["ms"] for r in pl]
    rec = dict(
        ranks=PT, card=card, shared_card=True,
        align=dict(iterations=al["iterations"], single_iterations=[int(s.iterations) for s in singles],
                   inliers=al["inliers"], single_inliers=[int(s.num_inliers) for s in singles],
                   translation_max_abs_m=t_err, rotation_max=r_err, batched_linearizations=lin,
                   launches=[r["align"]["launches"] for r in ranks],
                   ms_per_registration=[r["align"]["ms_per_registration"] for r in ranks]),
        pipeline=dict(scans=PT_SCANS, max_divergence_mm=div * 1e3, keyframe_flags=flags,
                      keyframe_flags_jax=ref["keyframe_added"][:PT_SCANS].tolist(),
                      step_ms=[[r["ms"] for r in k["pipeline"]] for k in ranks],
                      median_ms=statistics.median(ms[WARMUP_SCANS:]),
                      check_agree_ms=[r["check_agree_ms"] for r in ranks],
                      launches=[[r["launches"] for r in k["pipeline"]] for k in ranks],
                      linearizations=[[r["linearizations"] for r in k["pipeline"]] for k in ranks],
                      tracker_updates_and_covariance_calls=[
                          [[r["tracker_updates"], r["covariance_calls"]] for r in k["pipeline"]] for k in ranks]),
        note="two ranks share one card: these times say nothing of multi-card scaling",
    )
    print("point_parallel " + json.dumps(rec), flush=True)
    check(al["iterations"] == rec["align"]["single_iterations"], "point-sharded align iterations differ")
    check(al["inliers"] == rec["align"]["single_inliers"], "point-sharded align inliers differ")
    check(t_err <= BATCH_T_ATOL_M and r_err <= BATCH_R_ATOL,
          f"point-sharded align differs from single aligns by {t_err} m, {r_err} rad")
    check(all(r["align"]["digest"] == al["digest"] for r in ranks), "ranks' align results differ")
    check(all(r["align"]["launches"].get("nn1_sparse_batched", 0) == lin for r in ranks),
          f"point-sharded align launched {rec['align']['launches']} for {lin} linearizations")
    check(div <= DIVERGENCE_BAR_M, f"point-parallel poses diverge {div * 1e3:.3f} mm from JAX")
    check(flags == rec["pipeline"]["keyframe_flags_jax"], "point-parallel keyframe flags differ from JAX")
    for i in range(PT_SCANS):
        scan = [k["pipeline"][i] for k in ranks]
        check(all(r["state_digest"] == scan[0]["state_digest"]
                  and r["output_digest"] == scan[0]["output_digest"] for r in scan),
              f"ranks' states or outputs differ after scan {i + 1}")
        for r in scan:
            check(r["s2m_converged"], f"point-parallel S2M did not converge at scan {i + 1}")
            check(r["residuals_len"] == n_points, f"residuals of {r['residuals_len']} rows, not {n_points}")
            check(r["launches"].get("nn1_sparse", 0) >= r["linearizations"],
                  f"scan {i + 1}: nn1_sparse launched {r['launches']} for {r['linearizations']} linearizations")
            check(r["launches"].get("knn_classes", 0) >= 1,
                  f"scan {i + 1}: knn_classes not launched for the point-parallel covariances")
            check(r["jv_host_reads"] == 0 and r["tracker_updates"] > 0
                  and r["launches"].get("jv_solve", 0) == r["tracker_updates"]
                  and r["launches"].get("regularize_plane", 0) + r["launches"].get("window_plane_cov", 0)
                  == r["covariance_calls"],
                  f"scan {i + 1}: jv_solve / regularize_plane / window_plane_cov launched {r['launches']} for "
                  f"{r['tracker_updates']} tracker updates and {r['covariance_calls']} covariance calls "
                  f"({r['jv_host_reads']} JV host reads)")
    total = {}
    for k in ranks:
        for part in [k["align"]["launches"]] + [r["launches"] for r in k["pipeline"]]:
            for name, v in part.items():
                total[name] = total.get(name, 0) + v
    # a point-sharded group keeps the split trial (the error is summed over
    # the ranks between the proposal and the decision)
    for k in ranks:
        for part in [k["align"]["launches"]] + [r["launches"] for r in k["pipeline"]]:
            check(part.get("lm_inner", 0) == 0 and part.get("lm_propose", 0) == part.get("lm_decide", 0) > 0,
                  f"point-parallel: the split trial's launches {part}")
    return total


def accuracy_phase(seq, card, out_path=None):
    """Phase 16: the accuracy tool's four card legs over all 64 scans.
    Returns the kernels' launches summed over the legs."""
    import importlib.util

    from dynamic_direct_lidar_odometry_tpu_torch import config
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    spec = importlib.util.spec_from_file_location("torch_accuracy", os.path.join(ROOT, "tools", "torch_accuracy.py"))
    acc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(acc)
    goldens = acc.load_goldens()
    digest = sequence.sequence_sha256(seq, len(seq))
    for name, g in goldens.items():
        check(int(g["n_scans"]) == len(seq) and str(g["scans_sha256"]) == digest,
              f"the {len(seq)} scans differ from {name}'s sequence (sha256 {digest})")
    cfg = config.bench_config()
    legs = {name: acc.run_leg(name, cfg, seq) for name in acc.CARD_LEGS}
    rep = acc.report(legs, goldens, card, len(seq))
    print("accuracy " + json.dumps(rep), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rep, f, indent=1)
    check(not rep["gates_not_run"], f"accuracy gates not run: {rep['gates_not_run']}")
    check(rep["pass"], f"accuracy gates failed: {[g for g in rep['gates'] if not g['ok']]}")
    for name, v in legs.items():  # in the launch gate too; stated here
        check_card_kernels(f"accuracy {name}", v["launches"], v["tracker_updates"], v["covariance_calls"],
                           v["jv_host_reads"], window=acc.LEGS[name]["path"] == "sparse")
    return {k: sum(v["launches"].get(k, 0) for v in legs.values())
            for k in ("nn1_sparse", "knn_classes", "jv_solve", "regularize_plane", "window_plane_cov")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke check of the PyTorch port on one GPU")
    ap.add_argument("--phases", default=",".join(str(p) for p in range(1, 18)),
                    help="comma-separated subset; the check is the full run")
    ap.add_argument("--accuracy-out", default=None, help="also write phase 16's report to this file")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    full = phases == set(range(1, 18))
    t_start = time.perf_counter()

    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import dynamic_direct_lidar_odometry_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from dynamic_direct_lidar_odometry_tpu_torch import config, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, nn_cuda, segmentation
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling, sequence

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
    print(f"at {time.perf_counter() - t_start:.1f} s: phase 2", flush=True)
    t0 = time.perf_counter()
    built = nn_cuda.build()
    print(f"build: {len(built)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, b in built.items():
        print(f"build {name}: {b.path.name} (nvcc {b.seconds:.2f} s)", flush=True)
        if b.log:
            print(b.log.strip(), flush=True)
    ptxas = {}
    for b in built.values():
        ptxas.update(ptxas_report(b.log))
    print("ptxas " + json.dumps(ptxas), flush=True)
    if all(b.seconds for b in built.values()):  # a library built earlier has no report
        check(set(ptxas) >= set(PTXAS_NAMES.values()) and all(v.get("spill_bytes") == 0 for v in ptxas.values()),
              f"ptxas reports a spill or misses a kernel: {ptxas}")

    ref_dlo, ref_ddlo = np.load(GOLDEN_DLO), np.load(GOLDEN_DDLO)
    ref_replay, ref_cli = np.load(GOLDEN_REPLAY), np.load(GOLDEN_CLI)
    n = int(ref_ddlo["n_scans"])
    check(int(ref_dlo["n_scans"]) == n == int(ref_replay["n_scans"]), "the goldens cover different scans")
    cfg_dlo = config.bench_config(dynamic_detection=False)
    cfg = config.bench_config()
    seq = None
    if phases & (set(range(3, 18)) - {11}):
        t0 = time.perf_counter()
        seq = sequence.steady_state_sequence(64)
        print(f"sequence: 64 scans {seq.H}x{seq.W} in {time.perf_counter() - t0:.1f} s (host)", flush=True)
        digest = sequence.sequence_sha256(seq, n)
        for ref in (ref_dlo, ref_ddlo, ref_replay):
            check(digest == str(ref["scans_sha256"]),
                  f"scans 0-{n - 1} differ from the reference sequence (sha256 {digest})")
        m = int(ref_cli["n_scans"])
        check(sequence.sequence_sha256(seq, m) == str(ref_cli["scans_sha256"]),
              f"scans 0-{m - 1} differ from the CLI reference sequence")

    launches, fresh_names = {}, None
    if 17 in phases:
        # ---- 17, its profiler half: in a process that has captured no
        # other graph (after phases 4-12 the profiler names kernels inside
        # conditional bodies wrongly, PERF.md §7; the rest of phase 17
        # runs last and prints how its names differ from these) ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 17 (profiler names)", flush=True)
        fresh_names = graph_names_phase(cfg, seq)

    # ---- 3. kernels vs their plain versions ----
    print(f"at {time.perf_counter() - t_start:.1f} s: phase 3", flush=True)
    records = {}
    if 3 in phases:
        query, s2s_t, s2m_t, odd_q, odd_t = kernel_inputs(cfg_dlo, seq, ref_dlo["poses"], dev)
        ties_t, long_q, long_t = stress_inputs(query, s2m_t)
        s2m_r = cfg.gicp.s2m.max_correspondence_distance
        s2s_r = cfg.gicp.s2s.max_correspondence_distance
        k = cfg.gicp.s2s.k_correspondences
        recs = [
            check_sparse("s2m", query, s2m_t, s2m_r),
            check_sparse("s2m_residual", query, s2m_t, 3.0 * s2m_r),
            check_sparse("s2s", query, s2s_t, s2s_r),
            check_sparse("sentinels_nonmultiple", odd_q, odd_t, s2m_r),
            check_sparse("s2m_ties", query, ties_t, s2m_r),
            check_sparse("s2m_long_list", long_q, long_t, s2m_r),
            check_dense("s2m_16k_x_64k", query, s2m_t),
            check_dense("s2s_16k_x_16k", query, s2s_t),
            check_dense("sentinels_nonmultiple", odd_q, odd_t),
            check_dense("ties_16k_x_64k", query, ties_t),
            check_classes(f"cov_k{k}", query, query, k),
            check_classes(f"cov_k{k}_half_query_0", query[: query.shape[0] // 2], query, k),
            check_classes(f"cov_k{k}_half_query_1", query[query.shape[0] // 2:], query, k),
            check_classes("cov_k20", query, query, 20),
            check_classes("sentinels_nonmultiple", odd_q, odd_q[: odd_q.shape[0] - 100], k),
            check_classes(f"cov_k{k}_r5", query, query, k, prune_radius=5.0),
            check_classes("sentinels_nonmultiple_r5", odd_q, odd_q[: odd_q.shape[0] - 100], k,
                          prune_radius=5.0),
            check_classes("ties_16k_x_64k", query, ties_t, k),
            check_classes("ties_16k_x_64k_r5", query, ties_t, k, prune_radius=5.0),
            check_classes("k1", query, query, 1),
            check_classes("k128", query, query, 128),
            check_classes("one_chunk", query, query[:512], k),
            check_classes("chunks_of_128_odd_count", odd_q, odd_q[: odd_q.shape[0] - 100], k,
                          t_chunk=128),
            check_classes("chunks_of_128_odd_count_r5", odd_q, odd_q[: odd_q.shape[0] - 100], k,
                          prune_radius=5.0, t_chunk=128),
            check_classes(f"cov_k{k}_r5_empty_tile", query, query, k, prune_radius=5.0, empty_tile=2),
        ]
        # 8 stacked S2M problems: the submap, its long list, its ties, its
        # sentinels (padded to the common shape), moved and rolled copies
        big = torch.full((s2m_t.shape[0] - odd_t.shape[0], 3), 1.0e6, device=dev)
        odd_tp = torch.cat([odd_t, big])
        odd_qp = torch.cat([odd_q, torch.full((query.shape[0] - odd_q.shape[0], 3), 1.0e6, device=dev)])
        bq = torch.stack([query, long_q, query, odd_qp, query + 0.3, query, query.roll(511, 0), long_q])
        bt = torch.stack([s2m_t, long_t, ties_t, odd_tp, s2m_t, s2m_t + 0.05, ties_t, long_t])
        recs += [check_sparse_batched("s2m_b8", bq, bt, s2m_r),
                 check_sparse_batched("s2m_residual_b8", bq, bt, 3.0 * s2m_r)]
        for r in recs:
            records.setdefault(r["kernel"], []).append(r)
        records["regularize_plane"] = [check_regularize(query, k)]
        records["window_plane_cov"] = check_window_cov(window_cov_cases(cfg, query, s2m_t, odd_q, k))
        records["jv_solve"] = [check_jv(jv_cases(dev), "random_ties_big_nan_N32_64_128_256",
                                        also_time=("uniform_N64_all", "uniform_N128_all", "uniform_N256_all"))]
        records["set_cond"] = [check_set_cond(dev)]
        lm_propose_cases, lm_decide_cases = lm_trial_cases(dev)
        records["lm_propose"] = [check_lm_propose(lm_propose_cases, "synthetic_and_half_angle_sweep", 0)]
        records["lm_decide"] = [check_lm_decide(lm_decide_cases, "scenarios_and_convergence_boundary", 0)]
        del lm_propose_cases, lm_decide_cases
        records["lm_inner"] = [check_lm_inner(lm_inner_cases(dev), "synthetic_routes_and_scenarios", 4)]
        records["span"] = [check_span(cfg, seq, dev)]
        records["segment_objects"] = [check_segment_objects(segment_cases(dev), "cpu_test_cases")]

    sparse_launches = {}  # nn1_sparse per phase that runs it, each read right after it
    card_launches = {}  # CARD_KERNELS per phase, each read right after it
    if 4 in phases:
        # ---- 4. plain DLO ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 4", flush=True)
        with main_path_counts() as got:
            poses, steps = run_slice(cfg_dlo, seq.points[:n], seq.mask[:n], seq.stamps[:n], dev, timed=True)
        linz = sum(r["s2s_iterations"] + r["s2m_iterations"] + 1 for r in steps)
        summary, div = slice_summary("plain DLO", poses, steps, ref_dlo, seq, n, card)
        print("slice " + json.dumps(dict(summary, launches=got, linearizations=linz)), flush=True)
        check(got.get("nn1_sparse", 0) >= linz > 0, f"nn1_sparse launched {got} for {linz} linearizations")
        check(div <= DIVERGENCE_BAR_M, f"plain DLO poses diverge {div * 1e3:.3f} mm from JAX")
        sparse_launches[4] = got["nn1_sparse"]

    keep = n // 2
    inputs = None
    s2m = []
    if phases & {5, 6, 13, 15}:
        # ---- 5. full DDLO, default backends ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 5", flush=True)
        segmentation.SWEEPS.clear()
        with main_path_counts("ddlo", window=True) as card_launches[5]:
            poses, steps = run_slice(cfg, seq.points[:n], seq.mask[:n], seq.stamps[:n], dev,
                                     timed=True, keep=keep)
        sparse_launches[5] = card_launches[5]["nn1_sparse"]
        ccl_sweeps = card_launches[5]["ccl_sweeps"]
        # the S2M registrations (phase 13) and the tracker's cost matrices
        # (phase 3) are recorded from an eager run of the same scans: a
        # graph replay calls no Python
        with s2m_calls(ALIGN_B) as s2m, recorded_calls(hungarian, "solve") as solves, \
                recorded_trials() as trials, \
                recorded_calls(segmentation, "segment_objects", clone=True) as seg_calls, \
                profiling.device_counts("cuda") as eager_counts:
            eager_poses, _ = run_slice(cfg, seq.points[:n], seq.mask[:n], seq.stamps[:n], dev, eager=True)
        linz = sum(r["s2s_iterations"] + r["s2m_iterations"] + 1 for r in steps)
        inputs = steps[keep - 1].pop("inputs")
        summary, div = slice_summary("DDLO", poses, steps, ref_ddlo, seq, n, card)
        dets = [r["detections"] for r in steps]
        jax_dets = ref_ddlo["detections"].tolist()
        summary.update(
            launches=card_launches[5], linearizations=linz,
            detections=dets, detections_jax=jax_dets,
            track_status=[r["status"] for r in steps],
            track_status_jax=ref_ddlo["track_status"].tolist(),
            ccl_sweeps=ccl_sweeps,
            ccl_host_reads_graph_warmup=segmentation.SWEEPS["host_reads"],
            eager_poses_equal=bool(np.array_equal(eager_poses, poses)),
        )
        print("ddlo " + json.dumps(summary), flush=True)
        check_trial_launches("ddlo graph", card_launches[5], trials)
        check_trial_launches("ddlo eager", eager_counts, trials)
        check(summary["keyframe_flags_match_jax"], "DDLO keyframe flags differ from JAX")
        check(sparse_launches[5] >= linz > 0, f"nn1_sparse launched {sparse_launches[5]} for {linz}")
        check(div <= DIVERGENCE_BAR_M, f"DDLO poses diverge {div * 1e3:.3f} mm from JAX")
        check(abs(sum(dets) - sum(jax_dets)) <= DETECTION_BAR * sum(jax_dets),
              f"{sum(dets)} valid detections against {sum(jax_dets)} in the JAX run")
        # phase 3's jv_solve check on every tracker cost matrix of the run,
        # timed on the solve with the most path steps
        if 3 in phases:
            cases = [(f"scan_solve_{i}", a[0], a[1] if len(a) > 1 else kw.get("row_valid"))
                     for i, (a, kw) in enumerate(solves)]
            steps_of = []
            for _, cost, rv in cases:
                hungarian.HOST_READS.clear()
                hungarian.solve_plain(cost, rv)
                steps_of.append(hungarian.HOST_READS["path"])
            rec = check_jv(cases, "bench_tracker_16_scans", time_case=int(np.argmax(steps_of)))
            rec.update(path_steps_per_solve=steps_of)
            records["jv_solve"].insert(0, rec)
            # phase 3's lambda loop check on every loop of the eager run,
            # timed on its first (an S2S loop, one stream), the last 8
            # loops stacked and the last at 65,536 points (device memory)
            loops, more = bench_inner_cases(trials)
            records["lm_inner"][:0] = [
                check_lm_inner(loops, "bench_loops_16_scans", 0),
                check_lm_inner(more[:1], "bench_stacked_B8", 0),
                check_lm_inner(more[1:], "bench_last_loop_x4_device_route", 0)]
            # the split trial's checks on each loop's first trial
            propose, decide = bench_split_trials(trials)
            records["lm_propose"].insert(0, check_lm_propose(propose, "bench_first_trials_16_scans", 0))
            records["lm_decide"].insert(0, check_lm_decide(decide, "bench_first_trials_16_scans", 0))
            del loops, more, propose, decide
            # the segment gates on every detection of the eager run, timed
            # on its first
            records["segment_objects"].insert(0, check_segment_objects(
                [(f"scan_{i}", a, kw) for i, (a, kw) in enumerate(seg_calls)], "bench_scans_16", 0))
        del seg_calls

    if 6 in phases:
        # ---- 6. detection + tracking, card vs host ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 6", flush=True)
        card_launches[6] = compare_detection(inputs, cfg)

    if 7 in phases:
        # ---- 7. full DDLO, dense backends ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 7", flush=True)
        with env(DDLO_NN_IMPL="pallas", DDLO_KNN_IMPL="pallas"), main_path_counts() as got:
            m = DENSE_SCANS
            poses, steps = run_slice(cfg, seq.points[:m], seq.mask[:m], seq.stamps[:m], dev, timed=True)
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
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 8", flush=True)
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

    if 9 in phases:
        # ---- 9. the replay loop ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 9", flush=True)
        sparse_launches[9], card_launches[9] = replay_phase(cfg, seq, ref_replay, card)

    if 10 in phases:
        # ---- 10. the CLI at its own capacity (blocked hulls) ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 10", flush=True)
        sparse_launches[10] = cli_phase(seq, ref_cli, card)

    if 11 in phases:
        # ---- 11. kantplatz at 512 x 512 ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 11", flush=True)
        sparse_launches[11], card_launches[11] = kantplatz_phase(card)

    if 12 in phases:
        # ---- 12. step_chunk ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 12", flush=True)
        sparse_launches[12] = chunk_phase(cfg, seq, dev)

    problems = align_problems(s2m) if phases & {13, 15} else None
    if 13 in phases:
        # ---- 13. batched_align: one batched sparse launch per linearization ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 13", flush=True)
        launches["nn1_sparse_batched"] = batched_align_phase(problems, card)

    if 14 in phases:
        # ---- 14. replay_batch ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 14", flush=True)
        sparse_launches[14] = replay_batch_phase(cfg, seq, card)

    if 15 in phases:
        # ---- 15. point-parallel alignment and pipeline, PT ranks ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 15", flush=True)
        pt_launches = point_parallel_phase(problems, seq, ref_ddlo, card)
        sparse_launches[15] = pt_launches.get("nn1_sparse", 0)
        card_launches[15] = {k: pt_launches.get(k, 0) for k in CARD_KERNELS}
        for name in ("nn1_sparse_batched", "knn_classes"):
            launches[name] = launches.get(name, 0) + pt_launches.get(name, 0)
        PATH_LAUNCHES.update({k: pt_launches.get(k, 0) for k in ("lm_propose", "lm_decide")})

    if 16 in phases:
        # ---- 16. the accuracy tool's card legs, 64 scans ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 16", flush=True)
        acc_launches = accuracy_phase(seq, card, args.accuracy_out)
        sparse_launches[16] = acc_launches["nn1_sparse"]
        card_launches[16] = {k: acc_launches[k] for k in CARD_KERNELS}
        launches["knn_classes"] = launches.get("knn_classes", 0) + acc_launches["knn_classes"]
    if 17 in phases:
        # ---- 17. the step and the chunk as captured graphs ----
        print(f"at {time.perf_counter() - t_start:.1f} s: phase 17", flush=True)
        launches["set_cond"] = graph_phase(cfg, seq, card, fresh_names)["launches"]["set_cond"]
    launches["nn1_sparse"] = sum(sparse_launches.values())
    launches.update({k: PATH_LAUNCHES[k] for k in ("lm_inner", "lm_propose", "lm_decide", "span",
                                                    "segment_objects")})
    for k in CARD_KERNELS:
        launches[k] = sum(v.get(k, 0) for v in card_launches.values())
    print(f"nn1_sparse launches by phase: {json.dumps(sparse_launches)}", flush=True)
    print(f"jv_solve / regularize_plane / window_plane_cov launches by phase: {json.dumps(card_launches)}",
          flush=True)
    print(f"wall: {time.perf_counter() - t_start:.1f} s", flush=True)

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
            ms=main_case["ms"], timer=main_case["timer"], kernel_ms=main_case["kernel_ms"],
            call_ms=main_case["call_ms"],
            plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=None, cdist_ms=main_case.get("cdist_ms"), eigh_ms=main_case.get("eigh_ms"),
            topk_ms=main_case.get("topk_ms"),
            case=main_case["case"],
            **ptxas.get("nn1_sparse" if name == "nn1_sparse_batched" else name, {}),
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
