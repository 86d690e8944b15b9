"""Offline replay loop (counterpart of ``runner.py``): the launch file
and node graph of the reference (``ddlo_odom_node``, ``ddlo_map_node``,
``trajectories_server``, SURVEY.md §1) as one host loop:

  per scan:  state', out = pipeline.step(cfg, state, scan)     [device]
             map    += keyframe        (if out.keyframe_added) [device]
             map    -= clear_map boxes (tracker feedback)      [device]
             pose row -> PoseRecorder, bboxes -> ObjectTrajectories [host]

Host bookkeeping runs ONE SCAN LATE, as in the JAX package: scan ``i``'s
step is dispatched first, then scan ``i-1`` is finalized. The order is
part of the result: with ``hulls="exact"`` the host hull masks that feed
step ``i`` come from the state after scan ``i-2``.

Also here: per-stage profiling (odom.cc:189-192; with the dashboard on,
tracing is on and the device spans fill its stage rows), reference-format
evaluation dumps (detection.cpp:910-954), checkpoint/resume, and the
end-of-run map save (map.cc:158-189).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.io import pcd as pcd_io
from dynamic_direct_lidar_odometry_tpu_torch.io.dataset import ScanSequence
from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes, odometry
from dynamic_direct_lidar_odometry_tpu_torch.tracking.tracker import DYNAMIC
from dynamic_direct_lidar_odometry_tpu_torch.utils import checkpoint as ckpt
from dynamic_direct_lidar_odometry_tpu_torch.utils import evaldump, profiling, trajectory
from dynamic_direct_lidar_odometry_tpu_torch.utils.metrics import ate_rmse  # noqa: F401

_STATUS_NAMES = ("UNDEFINED", "STATIC", "DYNAMIC")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class ReplayResult:
    poses: np.ndarray  # (S, 3)
    quats: np.ndarray  # (S, 4) wxyz
    stamps: np.ndarray  # (S,)
    num_keyframes: int
    map_points: int
    dropped_scans: int
    profiler: profiling.Profiler
    pose_recorder: trajectory.PoseRecorder
    object_trajectories: trajectory.ObjectTrajectories
    dynamic_counts: np.ndarray  # (S,) dynamic pixels per scan
    final_state: pipeline.DDLOState
    map_state: mapper.MapState
    keyframe_overflow: int = 0  # keyframes accepted past store capacity


def replay(
    cfg: DDLOConfig,
    seq: ScanSequence,
    out_dir: Optional[str] = None,
    map_capacity: int = 500_000,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    evaluate: bool = False,
    progress: bool = False,
    dashboard_every: int = 0,
    viz_every: int = 0,
    save_every: int = 0,
    export_clouds_every: int = 0,
    hulls: str = "device",
    device="cuda",
) -> ReplayResult:
    """Run the full DDLO node graph over a scan sequence on ``device``
    (the card unless the caller asks for the CPU; without a card the
    default raises).

    ``hulls``: the keyframe hull source. ``"device"`` (the default) lets
    ``odometry.step`` compute the exact hulls on the device, cached until
    a keyframe insert; ``"exact"`` computes them on the host with scipy
    (:func:`keyframes.exact_hull_masks`), the JAX package's default.

    Mid-run artifacts (the reference's services and rviz topics):

    - ``save_every=N``: every N scans, the map and trajectories into
      ``out_dir`` tagged with the scan index (``save_pcd`` /
      ``save_trajectories``); ``SIGUSR1`` asks for the same snapshot at
      the next scan.
    - ``export_clouds_every=N``: every N scans, the S2M residual cloud,
      the static cloud and the keyframe positions as PCDs under
      ``out_dir/clouds/`` (odom.cc:43-52).
    - ``out_dir/tracks.jsonl``: one JSON line per active track per scan
      (publishBBoxes, tracking.cpp:257-398).
    - ``checkpoint_every=N``: ``out_dir/ckpt_%06d.npz`` of the state and
      the map; ``resume_from`` continues from one.
    """
    if hulls not in ("device", "exact"):
        raise ValueError(f"hulls must be 'device' or 'exact', not {hulls!r}")
    dev = device_mod.resolve(device)
    if cfg.evaluate:
        evaluate = True
        if not out_dir and cfg.evaluation_dir:
            out_dir = cfg.evaluation_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    eval_dump = None
    if evaluate and out_dir:
        eval_dump = evaldump.EvalDump(out_dir, cfg.evaluation_cfg_path or None)

    prof = profiling.Profiler()
    pose_rec = trajectory.PoseRecorder()
    obj_trajs = trajectory.ObjectTrajectories()
    track_log = (
        open(os.path.join(out_dir, "tracks.jsonl"), "w")
        if out_dir and cfg.dynamic_detection
        else None
    )

    # gravity alignment (initializeDDLO -> gravityAlign, odom.cc:599-612)
    T0 = None
    if cfg.gravity_align and seq.imu_accel is not None:
        T0 = odometry.gravity_align(seq.imu_accel)
    state = pipeline.init_state(
        cfg, seq.points[0], seq.mask[0], float(seq.stamps[0]), T0=T0, device=dev
    )
    map_state = mapper.empty_map(map_capacity, device=dev)
    # the first keyframe reaches the map like every other (map.cc:101-131)
    map_state = mapper.add_keyframe(
        map_state,
        state.odom.store.points[0],
        state.odom.store.masks[0],
        cfg.map.leaf_size,
        use_voxel_filter=cfg.map.use_voxel_filter,
    )
    start = 1

    if resume_from:
        (state, map_state), meta = ckpt.restore(resume_from, (state, map_state))
        start = int(meta.get("next_scan", 1))

    poses, quats, dyn_counts, stamps_kept = [], [], [], []
    dropped = 0
    n_scans = len(seq)

    def host_hulls(st):
        """The exact hull masks of ``st``'s keyframe store, from the host
        oracle, or None for the device hulls."""
        if hulls == "device":
            return None
        cv, cc = keyframes.exact_hull_masks(
            _np(st.odom.store.positions), _np(st.odom.store.valid),
            float(st.odom.keyframe_thresh_dist),
        )
        return torch.from_numpy(cv).to(dev), torch.from_numpy(cc).to(dev)

    hull_masks = host_hulls(state)

    # on-demand snapshot flag, set by SIGUSR1 and consumed at the next finalize
    save_requested = {"flag": False}
    prev_usr1 = None
    if out_dir:

        def _on_usr1(signum, frame):
            save_requested["flag"] = True

        try:
            prev_usr1 = signal.signal(signal.SIGUSR1, _on_usr1)
        except ValueError:  # not on the main thread: signals unavailable
            prev_usr1 = None

    def save_snapshot(tag: str) -> None:
        """Map + trajectory snapshot (save_pcd, map.cc:158-189;
        save_trajectories, trajectories_server.cpp:83-124)."""
        snap_pts, snap_mask = mapper.snapshot(map_state, cfg.map.leaf_size, map_capacity)
        pcd_io.save_pcd(os.path.join(out_dir, f"map_{tag}.pcd"), _np(snap_pts), _np(snap_mask))
        pose_rec.save(os.path.join(out_dir, f"trajectory_tum_{tag}.txt"))
        obj_trajs.save(os.path.join(out_dir, f"object_traj_{tag}"))

    def finalize(p) -> bool:
        """Host and map bookkeeping for an already-dispatched scan (the
        host span ``runner.finalize``). Returns False if the scan's pose
        went non-finite (the caller rolls back)."""
        with _FINALIZE:
            return bookkeeping(p)

    def bookkeeping(p) -> bool:
        nonlocal map_state, hull_masks
        i, out, st = p["i"], p["out"], p["state"]

        # NaN watchdog (the reference has no failure detection, SURVEY.md
        # §5): a non-finite pose would poison every later scan
        T_np = _np(out.odom.T)
        if not np.all(np.isfinite(T_np)):
            return False

        hull_masks = host_hulls(st)

        # ---- map node feedback loop (map.cc:101-156) ----
        if bool(out.keyframe_added):
            map_state = mapper.add_keyframe(
                map_state,
                out.new_keyframe_points,
                out.new_keyframe_mask,
                cfg.map.leaf_size,
                use_voxel_filter=cfg.map.use_voxel_filter,
            )
        if cfg.map.filter_bbox_history and bool(out.tracks.clear_map_valid.any()):
            map_state = mapper.remove_boxes(
                map_state,
                out.tracks.clear_map_boxes,
                out.tracks.clear_map_valid,
                margin=cfg.map.filter_margin,
            )

        # ---- host-side recording ----
        pose = _np(out.odom.pose)
        quat = _np(out.odom.rotq)
        poses.append(pose)
        quats.append(quat)
        stamps_kept.append(p["stamp"])
        pose_rec.append(p["stamp"], pose, quat)
        trk = st.tracks
        active, status = _np(trk.active), _np(trk.status)
        obj_trajs.update(
            _np(trk.filter_id), _np(trk.obj_state), active & (status == DYNAMIC), p["stamp"]
        )
        if track_log is not None and active.any():
            # per-frame all-status track export (publishBBoxes,
            # tracking.cpp:257-398)
            ids, x = _np(trk.filter_id), _np(trk.x)
            hits, det_slot = _np(trk.hits), _np(trk.det_slot)
            for s in np.nonzero(active)[0]:
                track_log.write(json.dumps({
                    "scan": i,
                    "stamp": p["stamp"],
                    "id": int(ids[s]),
                    "status": _STATUS_NAMES[int(status[s])],
                    "state": [round(float(v), 4) for v in x[s, :7]],
                    "velocity": [round(float(v), 4) for v in x[s, 7:10]],
                    "hits": int(hits[s]),
                    "matched": bool(det_slot[s] >= 0),
                }) + "\n")
        dyn_np = _np(out.dynamic_mask)
        n_dyn = int(dyn_np.sum())
        dyn_counts.append(n_dyn)

        if viz_every and out_dir and i % viz_every == 0:
            # DetectionModule::visualize (detection.cpp:834-909) as PNGs
            from dynamic_direct_lidar_odometry_tpu_torch.utils import viz

            viz.save_debug_images(
                os.path.join(out_dir, "images"),
                i,
                _np(out.detections.range_image),
                _np(out.detections.residual_image),
                _np(out.detections.labels),
                dilate_kernel_size=cfg.detection.dilate_kernel_size,
            )

        if eval_dump is not None:
            # %04d.txt dynamic indices + poses.txt (detection.cpp:936-952)
            eval_dump.frame(i, np.nonzero(dyn_np)[0], p["stamp"], T_np)

        if out_dir and export_clouds_every and i % export_clouds_every == 0:
            cdir = os.path.join(out_dir, "clouds")
            os.makedirs(cdir, exist_ok=True)
            pcd_io.save_pcd(
                os.path.join(cdir, f"{i:05d}_residuals.pcd"),
                _np(out.odom.reg_points_world),
                _np(out.odom.reg_mask),
                intensity=_np(out.odom.residuals),
            )
            pcd_io.save_pcd(
                os.path.join(cdir, f"{i:05d}_static.pcd"),
                _np(out.static_points),
                _np(out.static_mask),
            )
            pcd_io.save_pcd(
                os.path.join(cdir, f"{i:05d}_keyframes.pcd"),
                _np(st.odom.store.positions),
                _np(st.odom.store.valid),
            )

        if out_dir and (save_requested["flag"] or (save_every and i % save_every == 0)):
            save_requested["flag"] = False
            save_snapshot(f"{i:05d}")

        if checkpoint_every and out_dir and i % checkpoint_every == 0:
            ckpt.save(
                os.path.join(out_dir, f"ckpt_{i:06d}.npz"),
                (st, map_state),
                meta={"next_scan": i + 1},
            )

        if progress:
            print(
                f"scan {i}/{n_scans - 1} pose=({pose[0]:+.2f}, "
                f"{pose[1]:+.2f}, {pose[2]:+.2f}) dyn_px={n_dyn}"
            )
        if dashboard_every and i % dashboard_every == 0:
            stage_rows(prof, profiling.interval(dev))
            print(
                debug_dashboard(
                    prof, i, n_scans, pose, quat,
                    int(st.odom.store.valid.sum()),
                    int(mapper.num_points(map_state)),
                    int(active.sum()),
                    n_dyn,
                )
            )
        return True

    def upload(i):
        """Scan ``i`` on the device; from pinned memory without blocking
        the host on the card, so the copy overlaps the step in flight."""
        pts, msk = torch.from_numpy(seq.points[i]), torch.from_numpy(seq.mask[i])
        if dev.type == "cuda":
            pts, msk = pts.pin_memory(), msk.pin_memory()
        return pts.to(dev, non_blocking=True), msk.to(dev, non_blocking=True)

    # tracing on under the dashboard: its stage rows read the device spans
    with profiling.device_counts(dev) if dashboard_every else contextlib.nullcontext():
        pending = None  # the scan whose bookkeeping is deferred one iteration
        last_t = None
        staged = None  # (idx, pts, msk): the next scan, uploaded one scan ahead
        for i in range(start, n_scans):
            # low-return scan drop (odom.cc:635-639: "Low number of points!")
            if int(seq.mask[i].sum()) < cfg.gicp.min_num_points:
                dropped += 1
                continue
            if staged is not None and staged[0] == i:
                pts, msk = staged[1], staged[2]
            else:
                pts, msk = upload(i)
            staged = None
            ts = float(np.float32(seq.stamps[i]))

            # per-scan wall time, dispatch to dispatch: the step plus the
            # overlapped bookkeeping (the reference's "total", odom.cc:617-618,715)
            now = time.perf_counter()
            if last_t is not None:
                prof["total"].add((now - last_t) * 1e3)
            last_t = now

            prev_state = state
            state, out = pipeline.step(cfg, state, pts, msk, ts, hull_masks)

            if pending is not None and not finalize(pending):
                # the pending scan's pose was non-finite: restore the state
                # from before it, drop the step built on it, and dispatch this
                # scan again against the restored state
                state = pending["prev_state"]
                dropped += 1
                pending = None
                last_t = None
                prev_state = state
                state, out = pipeline.step(cfg, state, pts, msk, ts, hull_masks)
            if i + 1 < n_scans and int(seq.mask[i + 1].sum()) >= cfg.gicp.min_num_points:
                staged = (i + 1, *upload(i + 1))
            pending = {
                "i": i, "out": out, "state": state,
                "prev_state": prev_state, "stamp": float(seq.stamps[i]),
            }
        if pending is not None:
            if not finalize(pending):
                state = pending["prev_state"]
                dropped += 1
            if last_t is not None:
                prof["total"].add((time.perf_counter() - last_t) * 1e3)

    if prev_usr1 is not None:
        signal.signal(signal.SIGUSR1, prev_usr1)
    if track_log is not None:
        track_log.close()

    # keyframe-store saturation (at capacity each insert evicts the
    # farthest non-hull keyframe, keyframes.add_keyframe)
    kf_overflow = int(keyframes.overflow_count(state.odom.store))
    if kf_overflow > 0:
        print(
            f"[ddlo] WARNING: keyframe store saturated — {kf_overflow} "
            "inserts evicted the farthest non-hull keyframe; raise "
            "capacity.max_keyframes if full-sweep coverage is needed",
            file=sys.stderr,
        )

    if out_dir:
        pose_rec.save(os.path.join(out_dir, "trajectory_tum.txt"))
        obj_trajs.save(os.path.join(out_dir, "object_traj"))
        snap_pts, snap_mask = mapper.snapshot(map_state, cfg.map.leaf_size, map_capacity)
        pcd_io.save_pcd(os.path.join(out_dir, "map.pcd"), _np(snap_pts), _np(snap_mask))

    return ReplayResult(
        poses=np.stack(poses) if poses else np.zeros((0, 3)),
        quats=np.stack(quats) if quats else np.zeros((0, 4)),
        stamps=np.asarray(stamps_kept),
        num_keyframes=int(state.odom.store.valid.sum()),
        map_points=int(mapper.num_points(map_state)),
        dropped_scans=dropped,
        profiler=prof,
        pose_recorder=pose_rec,
        object_trajectories=obj_trajs,
        dynamic_counts=np.asarray(dyn_counts),
        final_state=state,
        map_state=map_state,
        keyframe_overflow=kf_overflow,
    )


def _cpu_stats() -> tuple:
    """Process CPU utilization since the previous call, plus core count
    and model: the reference dashboard's CPU block (odom.cc:1430-1458)."""
    t = os.times()
    cpu = t.user + t.system
    now = time.monotonic()
    prev = getattr(_cpu_stats, "_prev", None)
    _cpu_stats._prev = (cpu, now)
    pct = 0.0
    if prev is not None and now > prev[1]:
        pct = 100.0 * (cpu - prev[0]) / (now - prev[1])
    model = getattr(_cpu_stats, "_model", None)
    if model is None:
        model = "unknown cpu"
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith("model name"):
                        model = line.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        _cpu_stats._model = model
    return pct, os.cpu_count() or 1, model


_FINALIZE = profiling.span("runner.finalize")


def stage_rows(prof: profiling.Profiler, spans: dict) -> None:
    """An interval's spans (``profiling.interval``) in the dashboard's
    rows, as mean ms a scan: device spans in ``odometry`` (preprocess
    through S2M), ``dynamic`` (detection and the tracker) and
    ``trackDetections`` (the tracker); the host span ``runner.finalize``
    (the replay's bookkeeping of a scan, one scan late) in ``finalize``.
    No span feeds ``projectScan``, ``projectResiduals``,
    ``groundRemoval``, ``cloudSegmentation`` or ``computeAllObjects``
    (stages inside ``detection``); ``total`` is the host's
    dispatch-to-dispatch time."""
    n = spans.get("span.preprocess.n")
    if n:
        def ms(*names):
            return sum(spans.get(f"span.{s}.ns", 0) for s in names) / n / 1e6

        prof["odometry"].add(ms(*profiling.STAGE_SPANS[:5]))
        if spans.get("span.detection.n"):
            prof["dynamic"].add(ms("detection", "tracker"))
            prof["trackDetections"].add(ms("tracker"))
    if spans.get("host.runner.finalize.n"):
        prof["finalize"].add(spans["host.runner.finalize.ns"] / spans["host.runner.finalize.n"] / 1e6)


def debug_dashboard(
    prof: profiling.Profiler,
    scan_idx: int,
    n_scans: int,
    pose: np.ndarray,
    quat: np.ndarray,
    num_keyframes: int,
    map_points: int,
    active_tracks: int,
    dynamic_pixels: int,
) -> str:
    """Console dashboard (OdomNode::debug, odom.cc:1317-1461): pose,
    store sizes, host memory, and the per-stage timing table. The text
    is the JAX package's, so tools that read one read the other."""
    rss_mb = 0.0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss_mb = float(line.split()[1]) / 1024.0
                    break
    except OSError:
        pass
    lines = [
        "+" + "-" * 62 + "+",
        "| DDLO (TPU)  scan %6d / %-6d            RSS %8.1f MB |"
        % (scan_idx, n_scans - 1, rss_mb),
        "| pose  xyz (%+8.3f, %+8.3f, %+8.3f) m                |"
        % (pose[0], pose[1], pose[2]),
        "| quat wxyz (%+.3f, %+.3f, %+.3f, %+.3f)                   |"
        % (quat[0], quat[1], quat[2], quat[3]),
        "| keyframes %5d   map %9d pts   tracks %3d   dyn px %5d"
        % (num_keyframes, map_points, active_tracks, dynamic_pixels),
        "| host cpu %5.1f %% of %d cores (%.28s)"
        % _cpu_stats(),
        "+" + "-" * 62 + "+",
        prof.dashboard(),
    ]
    return "\n".join(lines)
