"""Trajectory-level accuracy of the port's card paths (the counterpart of
``tools/accuracy_tpu.py``).

Replays ``bench_config()`` over the 64 scans of ``steady_state_sequence(64)``
through the port's ``runner.replay`` in four card legs,

  gpu_default     : sparse 1-NN kernel + Morton-window covariances (the default)
  gpu_exact       : DDLO_NN_IMPL=exact, DDLO_KNN_IMPL=exact (no NN kernel runs)
  gpu_exact_hulls : the default backends with the host's exact hulls
  gpu_laneclass   : DDLO_KNN_IMPL=pallas (lane-class k-NN kernel covariances)

and holds them to each other and to two JAX CPU trajectories committed by
``tools/torch_port_reference_poses.py --accuracy``:

  jax_cpu_exact   : the JAX tool's ``cpu_exact`` leg
  jax_cpu_window  : the JAX package on the CPU with only its covariance
                    taking the window path: the function ``gpu_default``
                    computes

Bars: the JAX tool's three (default vs exact < 1 cm and device vs exact
hulls < 1 cm as stamp-aligned RMSE, every leg < 5 cm from the ground
truth), and two as max divergence over scans: ``gpu_default`` within 1 cm
of ``jax_cpu_window``, ``gpu_exact`` within 1 cm of ``jax_cpu_exact``.
``gpu_laneclass`` is held to the same bars against ``gpu_exact`` and
``jax_cpu_exact``. ``gpu_default`` vs ``jax_cpu_exact`` and the two JAX
runs against each other are reported, not gated: they show what the
window approximation costs apart from the port. Each leg also checks that
it took its path, from the kernels' launch counts: its NN kernels and, on
the card, one ``jv_solve`` launch per tracker update and one covariance
kernel launch per covariance call (``window_plane_cov`` on the window
path, ``regularize_plane`` on the exact one), with no host read of the
JV assignment. Keyframe counts and map
points are reported beside the JAX runs' and not gated.

A card leg raises without a CUDA card. ``--legs port_cpu_exact`` runs the
port on the host in the exact environment, for comparison with
``jax_cpu_exact`` (11-25 min on 8 host cores). The legs run in one process: the
port reads ``DDLO_*`` per call, and each leg restores them afterwards.
Writes the report (``ACCURACY_torch.json`` at the repo root by default)
and each leg's trajectory under ``.torch_accuracy_runs/``.

    python tools/torch_accuracy.py [--legs gpu_default,...] [--scans 64] [--out ACCURACY_torch.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {
    "jax_cpu_exact": os.path.join(REPO, "tests", "golden", "torch_port_accuracy64_jaxcpu_exact.npz"),
    "jax_cpu_window": os.path.join(REPO, "tests", "golden", "torch_port_accuracy64_jaxcpu_window.npz"),
}
RUNS = os.path.join(REPO, ".torch_accuracy_runs")
IMPL_VARS = ("DDLO_NN_IMPL", "DDLO_KNN_IMPL")
EXACT = {"DDLO_NN_IMPL": "exact", "DDLO_KNN_IMPL": "exact"}
# path: which NN kernels a leg must launch ("sparse": nn1_sparse for every
# linearization and residual pass; "laneclass": that and knn_classes for
# every covariance call; "none": no NN kernel)
LEGS = {
    "gpu_default": dict(device="cuda", env={}, hulls="device", path="sparse"),
    "gpu_exact": dict(device="cuda", env=EXACT, hulls="device", path="none"),
    "gpu_exact_hulls": dict(device="cuda", env={}, hulls="exact", path="sparse"),
    "gpu_laneclass": dict(device="cuda", env={"DDLO_KNN_IMPL": "pallas"}, hulls="device", path="laneclass"),
    "port_cpu_exact": dict(device="cpu", env=EXACT, hulls="device", path="none"),
}
CARD_LEGS = ("gpu_default", "gpu_exact", "gpu_exact_hulls", "gpu_laneclass")
# the like-for-like JAX run of a leg, for its keyframe flags
JAX_LIKE = {"gpu_default": "jax_cpu_window", "gpu_exact": "jax_cpu_exact",
            "port_cpu_exact": "jax_cpu_exact"}
# tools/accuracy_tpu.py's bars, under its names
BARS = {"default_vs_exact_lt_m": 0.01, "device_vs_exact_hulls_lt_m": 0.01, "vs_gt_lt_m": 0.05}
DIVERGENCE_BAR_M = 0.01  # milestone (c): max divergence from the like-for-like JAX run
# (a, b, metric, bar): metric "rmse" is the JAX tool's stamp-aligned
# pairwise ATE (held < bar), "max" the largest pose distance (held <= bar)
GATES = (
    ("gpu_default", "gpu_exact", "rmse", BARS["default_vs_exact_lt_m"]),
    ("gpu_default", "gpu_exact_hulls", "rmse", BARS["device_vs_exact_hulls_lt_m"]),
    ("gpu_default", "jax_cpu_window", "max", DIVERGENCE_BAR_M),
    ("gpu_exact", "jax_cpu_exact", "max", DIVERGENCE_BAR_M),
    ("gpu_laneclass", "gpu_exact", "rmse", BARS["default_vs_exact_lt_m"]),
    ("gpu_laneclass", "jax_cpu_exact", "max", DIVERGENCE_BAR_M),
)
REPORTED = (("gpu_default", "jax_cpu_exact"), ("jax_cpu_window", "jax_cpu_exact"),
            ("gpu_laneclass", "gpu_default"), ("port_cpu_exact", "jax_cpu_exact"))


def _refuse_dropped(*runs):
    for v in runs:
        if int(v.get("dropped", 0)) != 0:
            raise RuntimeError(
                f"variant dropped {int(v['dropped'])} scans; pairwise ATE "
                "would compare misaligned trajectories"
            )


def _aligned(a, b):
    _refuse_dropped(a, b)
    sa, sb = np.asarray(a["stamps"]), np.asarray(b["stamps"])
    common, ia, ib = np.intersect1d(sa, sb, return_indices=True)
    return common, np.asarray(a["poses"])[ia] - np.asarray(b["poses"])[ib]


def pairwise_ate(a, b) -> float:
    """RMSE between two runs' positions, aligned by scan stamp; refuses a
    run that dropped scans (``tools/accuracy_tpu.pairwise_ate``)."""
    common, d = _aligned(a, b)
    if len(common) == 0:
        return float("nan")
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def max_divergence(a, b) -> float:
    """The largest distance between two runs' positions over the scans
    they share, aligned as :func:`pairwise_ate`."""
    common, d = _aligned(a, b)
    if len(common) == 0:
        return float("nan")
    return float(np.linalg.norm(d, axis=1).max())


@contextlib.contextmanager
def leg_env(values):
    """``DDLO_NN_IMPL`` / ``DDLO_KNN_IMPL`` as ``values`` gives them (unset
    otherwise), restored on exit."""
    old = {k: os.environ.get(k) for k in IMPL_VARS}
    for k in IMPL_VARS:
        if k in values:
            os.environ[k] = values[k]
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _recorded_steps(pipeline):
    """Each ``pipeline.step``'s LM iteration counts and keyframe flag, as
    tensors (read after the replay, so the loop's overlap is kept)."""
    steps, real = [], pipeline.step

    def step(*a, **kw):
        state, out = real(*a, **kw)
        steps.append((out.odom.s2s_iterations, out.odom.s2m_iterations, out.keyframe_added))
        return state, out

    pipeline.step = step
    try:
        yield steps
    finally:
        pipeline.step = real


# launched on the card at every tracker update (jv_solve) and covariance
# call (one of the two covariance kernels: the exact path's
# regularize_plane, the window path's window_plane_cov), by any path
COVARIANCE_KERNELS = ("regularize_plane", "window_plane_cov")
CARD_KERNELS = ("jv_solve",) + COVARIANCE_KERNELS
# every kernel the legs can launch, by its wrapper's name (ops/nn_cuda.py)
KERNEL_NAMES = ("nn1_sparse", "nn1_dense", "nn1_sparse_batched", "knn_classes", "knn_classes_sparse",
                "jv_solve", "regularize_plane", "window_plane_cov", "set_cond")


def launch_check(path: str, launches: dict, linearizations: int, covariance_calls: int,
                 tracker_updates: int | None = None) -> bool:
    """Did the leg take its path? See :data:`LEGS`. On the card
    (``tracker_updates`` given) ``jv_solve`` launched once per tracker
    update and ``window_plane_cov`` or ``regularize_plane`` once per
    covariance call; on the host none of them ran."""
    # set_cond: a captured graph's loop tests (csrc/graph_cond.cu), not a
    # path's kernel
    got = {k: v for k, v in launches.items() if v and k != "set_cond"}
    if tracker_updates is None:
        if set(got) & set(CARD_KERNELS):
            return False
    elif (got.pop("jv_solve", 0) != tracker_updates
          or sum(got.pop(k, 0) for k in COVARIANCE_KERNELS) != covariance_calls):
        return False
    if path == "none":
        return not got
    sparse = got.get("nn1_sparse", 0) >= linearizations > 0
    others = set(got) - {"nn1_sparse", "nn1_key_fill", "knn_classes"}
    if path == "sparse":
        return sparse and not others and "knn_classes" not in got
    return sparse and not others and got.get("knn_classes", 0) >= covariance_calls > 0


def run_leg(name: str, cfg, seq, progress: bool = False) -> dict:
    """One leg: ``runner.replay`` of ``seq`` in the leg's environment, hulls
    and device. Returns the trajectory and what the report needs."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import runner
    from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian
    from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics, profiling

    spec = LEGS[name]
    card = spec["device"] == "cuda"
    if card and not torch.cuda.is_available():
        raise RuntimeError(f"leg {name} runs on a CUDA card, and there is none")
    # counted on the device (utils.profiling.count): on the card the steps
    # are graph replays, which launch kernels without calling the
    # wrappers (nn_cuda.LAUNCHES counts at capture)
    with leg_env(spec["env"]), _recorded_steps(runner.pipeline) as steps, \
            profiling.device_counts(spec["device"]) as counts:
        hungarian.HOST_READS.clear()
        t0 = time.perf_counter()
        res = runner.replay(cfg, seq, hulls=spec["hulls"], progress=progress, device=spec["device"])
        seconds = time.perf_counter() - t0
        jv_host_reads = sum(hungarian.HOST_READS.values())
    launches = {k: counts[k] for k in KERNEL_NAMES if counts.get(k)}
    cov_calls, updates = [counts.get("covariance_calls", 0)], [counts.get("tracker_updates", 0)]
    flags = np.array([bool(k) for _, _, k in steps], bool)
    linz = sum(int(a) + int(b) + 1 for a, b, _ in steps)  # + the residual pass
    tot = res.profiler["total"]
    return dict(
        poses=res.poses, quats=res.quats, stamps=res.stamps, dropped=res.dropped_scans,
        ate=metrics.ate_rmse(res.poses, seq.gt_poses, res.stamps, seq.stamps),
        num_keyframes=res.num_keyframes, map_points=res.map_points, keyframe_added=flags,
        total_ms_per_scan=dict(mean=tot.mean, min=tot.min, max=tot.max, n=tot.n),
        seconds=seconds, launches=launches, linearizations=linz, covariance_calls=cov_calls[0],
        tracker_updates=updates[0], jv_host_reads=jv_host_reads,
        launch_check=launch_check(spec["path"], launches, linz, cov_calls[0],
                                  updates[0] if card else None) and not (card and jv_host_reads),
    )


def load_goldens() -> dict:
    return {name: dict(np.load(path)) for name, path in GOLDEN.items()}


def first_flag_difference(a, b):
    """The first scan whose keyframe flag differs between two runs (scan 0
    is the init scan), or None."""
    fa, fb = np.asarray(a["keyframe_added"], bool), np.asarray(b["keyframe_added"], bool)
    m = min(len(fa), len(fb))
    diff = np.flatnonzero(fa[:m] != fb[:m])
    if len(diff):
        return int(diff[0]) + 1
    return None if len(fa) == len(fb) else m + 1


def report(legs: dict, goldens: dict, card: str, n_scans: int) -> dict:
    """The report of the legs that ran against the goldens: per-run
    figures, every pair as RMSE and max divergence, the gates and ``pass``
    (over the gates whose runs are all present; ``gates_not_run`` lists
    the others)."""
    runs = {**goldens, **legs}
    out = dict(
        sequence=f"steady_state_sequence(64), first {n_scans} scans, 64x2048, bench_config, runner.replay",
        n_scans=n_scans, card=card, bars=dict(BARS, max_divergence_le_m=DIVERGENCE_BAR_M),
        legs={}, jax_cpu={}, pairs={}, gates=[], gates_not_run=[],
    )
    for name, g in goldens.items():
        out["jax_cpu"][name] = dict(ate_vs_gt_m=float(g["ate"]), num_keyframes=int(g["num_keyframes"]),
                                    map_points=int(g["map_points"]), seconds=float(g["seconds"]))
    for name, v in legs.items():
        rec = {k: v[k] for k in ("num_keyframes", "map_points", "dropped", "total_ms_per_scan",
                                  "seconds", "launches", "linearizations", "covariance_calls",
                                  "launch_check")}
        rec.update({k: v[k] for k in ("tracker_updates", "jv_host_reads") if k in v})
        rec["ate_vs_gt_m"] = float(v["ate"])
        like = JAX_LIKE.get(name)
        if like in goldens:
            rec[f"num_keyframes_{like}"] = int(goldens[like]["num_keyframes"])
            rec[f"map_points_{like}"] = int(goldens[like]["map_points"])
            rec[f"first_keyframe_flag_difference_vs_{like}"] = first_flag_difference(v, goldens[like])
        out["legs"][name] = rec
    for a, b in [(a, b) for a, b, _, _ in GATES] + list(REPORTED):
        if a in runs and b in runs:
            out["pairs"][f"{a}_vs_{b}"] = dict(rmse_m=pairwise_ate(runs[a], runs[b]),
                                               max_divergence_m=max_divergence(runs[a], runs[b]))
    ok = []
    for a, b, metric, bar in GATES:
        pair = f"{a}_vs_{b}"
        if pair not in out["pairs"]:
            out["gates_not_run"].append(pair)
            continue
        value = out["pairs"][pair]["rmse_m" if metric == "rmse" else "max_divergence_m"]
        passed = value < bar if metric == "rmse" else value <= bar
        out["gates"].append(dict(pair=pair, metric=metric, bar_m=bar, value_m=value, ok=bool(passed)))
        ok.append(passed)
    for name, v in legs.items():
        passed = float(v["ate"]) < BARS["vs_gt_lt_m"]
        out["gates"].append(dict(pair=f"{name}_vs_ground_truth", metric="ate", bar_m=BARS["vs_gt_lt_m"],
                                 value_m=float(v["ate"]), ok=bool(passed)))
        out["gates"].append(dict(pair=f"{name}_launches", metric="path", ok=bool(v["launch_check"])))
        ok += [passed, v["launch_check"]]
    out["pass"] = bool(ok) and all(ok)
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def save_leg(name: str, rec: dict, runs_dir: str = RUNS) -> str:
    os.makedirs(runs_dir, exist_ok=True)
    path = os.path.join(runs_dir, f"{name}.npz")
    np.savez(path, **{k: rec[k] for k in ("poses", "quats", "stamps", "dropped", "ate", "num_keyframes",
                                          "map_points", "keyframe_added", "seconds")})
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(CARD_LEGS), help=f"comma-separated, of {', '.join(LEGS)}")
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(REPO, "ACCURACY_torch.json"))
    ap.add_argument("--progress", action="store_true")
    args = ap.parse_args(argv)
    names = args.legs.split(",")
    unknown = set(names) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}")

    sys.path.insert(0, REPO)
    from dynamic_direct_lidar_odometry_tpu_torch import config
    from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence

    goldens = load_goldens()
    seq = sequence.steady_state_sequence(64)
    digest = sequence.sequence_sha256(seq, 64)
    for gname, g in goldens.items():
        if str(g["scans_sha256"]) != digest:
            raise SystemExit(f"the rendered sequence differs from {gname}'s (sha256 {digest})")
    if args.scans != 64:
        from dynamic_direct_lidar_odometry_tpu_torch.io.dataset import ScanSequence

        n = args.scans
        seq = ScanSequence(points=seq.points[:n], mask=seq.mask[:n], stamps=seq.stamps[:n],
                           H=seq.H, W=seq.W, gt_poses=seq.gt_poses[:n])
    card = card_line() if any(LEGS[n]["device"] == "cuda" for n in names) else "host"
    cfg = config.bench_config()
    legs = {}
    for name in names:
        legs[name] = run_leg(name, cfg, seq, progress=args.progress)
        save_leg(name, legs[name])
        print(f"[torch_accuracy] {name}: ATE {legs[name]['ate'] * 1e3:.3f} mm, "
              f"{legs[name]['num_keyframes']} keyframes, {legs[name]['seconds']:.1f} s", flush=True)
    rep = report(legs, goldens, card, len(seq))
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep, indent=1))
    return 0 if rep["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
