"""Step the JAX package and the port in lockstep over the kantplatz
deployment's feed on the CPU (``kantplatz-k4a-512`` on ``k4a-walk``):
tells a fault of the port from DDLO's own behaviour on the Azure Kinect
512 x 512 camera.

    env JAX_PLATFORMS=cpu python tools/torch_kantplatz_lockstep.py --seed 3000000021 --lap 36-44
    env JAX_PLATFORMS=cpu python tools/torch_kantplatz_lockstep.py --seed 17179869261 --window 20
    env JAX_PLATFORMS=cpu python tools/torch_kantplatz_lockstep.py --align chiprun_out/kantplatz_align_3000000021_404.npz

The scans are ``cardbench/traffic/k4a-walk.json``'s, rendered on the CPU
by the benchmark's generator from ``--seed`` (the range noise is drawn
on the CPU, so it is not the card's draw; ``tools/torch_kantplatz_card_check.py
--render cpu`` steps the same scans on the card), under the deployment
(``cardbench/deployments/kantplatz-k4a-512.json``, the JAX package's
``kantplatz_config()`` at ``capacity_for_scan(512, 512)``).

- ``--lap A-B``: lap scans A..B; ``--window N``: the first N scans a run
  with the seed judges. JAX starts from ``init_state`` on the stretch's
  first scan at its true pose; per scan, JAX steps its state and the
  port steps a copy of the same JAX state (lockstep).
- ``--align FILE``: a step's ``gicp.align`` calls as the card made them
  (``tools/torch_kantplatz_card_check.py --save``: S2S, then S2M, from
  the card's own state and scan), run again by the JAX package and by
  the port on the CPU from the same inputs. One line a call: each
  result's distance from the card's (mm, mrad) and the iterations; the
  last line the step's motion error against the truth with the card's,
  JAX's and the host port's S2M pose.

One JSON line per lockstep:

- ``lock_mm`` / ``lock_mrad``: the port's pose from the JAX state
  against JAX's, and ``lock_kf_equal`` the keyframe flags;
- ``step_mm``: JAX's motion error at the step; ``pose_mm``: JAX's
  distance from the truth (JAX runs on by itself from the stretch's
  start);
- ``labels_vs_jax``: pixels whose ``label_components`` label differs
  from JAX's, and ``roots_equal``: whether ``segment_objects`` kept the
  same roots (the labels of the pixels it gave a slot);
- ``labels_vs_reference``: the port's labels against
  ``cardbench/reference/components.py``'s (``compare``: pixels that
  differ, pixels at an edge within one float32 ulp of theta, differing
  pixels no such edge explains).

On the camera grid the port's angle predicate takes the camera's pixel
angles (``detection.pixel_angles``), where the JAX package takes a
LiDAR's ring angles on every grid. So that JAX steps the port's path,
its ``label_components`` is handed the camera's angles here (the JAX
package's files are not changed); the port's other departure, no seam,
changes nothing inside the deployment's window (columns 156-356). On 8
CPU cores a 512 x 512 step takes ~3 min in JAX and ~4 min in the port
(the kernels' plain versions); JAX's S2M alone, at 65,536 x 262,144 from
a mapped state (``--align``), over 40 min. Run it in the background.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "cardbench"), os.path.join(ROOT, "cardbench", "reference")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

DEPLOYMENT = os.path.join(ROOT, "cardbench", "deployments", "kantplatz-k4a-512.json")
MIX = "k4a-walk"


def _roots(labels: np.ndarray, pixel_slot: np.ndarray) -> list:
    return sorted(set(labels[pixel_slot >= 0].tolist()))


def _rot_mrad(A: np.ndarray, B: np.ndarray) -> float:
    """||Ra - Rb||_F / sqrt(2): the angle between them to first order,
    well conditioned at 0 (the trace's arccos is not, on f32 matrices)."""
    d = A[:3, :3].astype(np.float64) - B[:3, :3].astype(np.float64)
    return float(np.linalg.norm(d) / np.sqrt(2.0)) * 1e3


def _steps(args, L: int, start: int) -> list:
    """The lap scan of each step, step 0 the init scan."""
    if args.lap:
        a, b = (int(x) for x in args.lap.split("-"))
        return [k % L for k in range(a, b + 1)]
    first = (start + L + 2) % L  # the judged lap's first step is L + 2
    return [(first - 1 + k) % L for k in range(args.window + 1)]


def align_calls(path: str) -> int:
    """``--align``: the saved calls in both packages on the CPU."""
    from reference import judge

    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    names = ("src_pts", "src_mask", "src_covs", "tgt_pts", "tgt_mask", "tgt_covs", "guess")
    z = np.load(path)
    jalign = jax.jit(jgicp.align, static_argnums=(7,))
    poses = {}
    for i in range(int(z["calls"])):
        a = [z[f"{i}_{n}"] for n in names]
        st = json.loads(str(z[f"{i}_settings"]))
        t0 = time.time()
        jr = jalign(*map(jnp.asarray, a), jgicp.GICPSettings(**{k: st[k] for k in jgicp.GICPSettings._fields}))
        jT = np.asarray(jr.T)
        t_jax = time.time() - t0
        pr = gicp.align(*map(torch.as_tensor, a), gicp.GICPSettings(**st))
        cT, pT = z[f"{i}_T"], pr.T.numpy()
        poses = dict(card=cT, jax=jT, port_cpu=pT)
        print(json.dumps(dict(call=i, points=[int(a[1].sum()), int(a[4].sum())],
                              iterations=[int(z[f"{i}_iterations"]), int(jr.iterations), int(pr.iterations)],
                              jax_vs_card_mm=float(np.abs(jT[:3, 3] - cT[:3, 3]).max()) * 1e3,
                              jax_vs_card_mrad=_rot_mrad(jT, cT),
                              port_cpu_vs_card_mm=float(np.abs(pT[:3, 3] - cT[:3, 3]).max()) * 1e3,
                              port_cpu_vs_jax_mm=float(np.abs(pT[:3, 3] - jT[:3, 3]).max()) * 1e3,
                              guess_vs_card_mm=float(np.abs(a[6][:3, 3] - cT[:3, 3]).max()) * 1e3,
                              jax_s=round(t_jax, 1))), flush=True)
    G = np.stack([z["G0"], z["G1"]]).astype(np.float64)
    step = {}
    for k, T in poses.items():  # the last call is S2M: its pose is the step's
        t, r = judge.motion_errors(np.stack([z["P0"].astype(np.float64), T.astype(np.float64)]), G)
        step[k] = [round(float(t[0]) * 1e3, 2), round(float(r[0]) * 1e3, 2)]
    card_t, _ = judge.motion_errors(np.stack([z["P0"], z["P1"]]).astype(np.float64), G)
    print(json.dumps(dict(file=os.path.basename(path), step_mm_mrad=step,
                          card_step_mm=float(card_t[0]) * 1e3)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--align", help="a saved step's gicp.align calls (.npz)")
    g.add_argument("--lap", help="lap scans A-B")
    g.add_argument("--window", type=int, help="the judged window's first N scans")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.align:
        return align_calls(args.align)
    if args.seed is None:
        ap.error("--seed is required")

    import components
    import harness
    from reference import judge
    from traffic import generator

    from dynamic_direct_lidar_odometry_tpu import config as jconfig
    from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
    from dynamic_direct_lidar_odometry_tpu.ops import segmentation as jsegmentation
    from dynamic_direct_lidar_odometry_tpu_torch import interop, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.core import se3
    from dynamic_direct_lidar_odometry_tpu_torch.detection import detection

    with open(DEPLOYMENT) as f:
        pcfg = harness.build_config(json.load(f))
    mix = generator.load_mix(MIX)
    jcfg = dataclasses.replace(jconfig.kantplatz_config(), capacity=jconfig.capacity_for_scan(512, 512))
    across, down, _ = detection.pixel_angles(pcfg.detection)
    jlabel = jsegmentation.label_components

    def camera_angles(ranges, eligible, theta, ang_res_x, ang_res_y, *a, **kw):
        return jlabel(ranges, eligible, theta, across, down, *a, **kw)

    jsegmentation.label_components = camera_angles
    L = int(mix["path"]["scans_per_lap"])
    scans = _steps(args, L, generator.start_offset(args.seed, L))
    need = sorted(set(scans))
    lap = generator.render_lap(mix, args.seed, "cpu", scans=need)
    at = {s: k for k, s in enumerate(need)}
    torch.nan_to_num_(lap.points)
    pts = [lap.points[at[s]] for s in scans]  # views
    msk = [lap.mask[at[s]] for s in scans]
    truth = lap.scene.poses[scans]
    dt = float(mix["dt"])

    T0 = truth[0].astype(np.float32)
    js = jpipe.init_state(jcfg, jnp.asarray(pts[0].numpy()), jnp.asarray(msk[0].numpy()), 0.0,
                          T0=jnp.asarray(T0))
    P = [T0.astype(np.float64)]
    for k in range(1, len(scans)):
        t0 = time.time()
        before = jax.tree_util.tree_map(lambda x: np.array(x, copy=True), js)
        js, jo = jpipe.step(jcfg, js, jnp.asarray(pts[k].numpy()), jnp.asarray(msk[k].numpy()),
                            jnp.float32(dt * k))
        jT = np.asarray(jo.odom.T)
        P.append(jT.astype(np.float64))
        t_jax = time.time() - t0
        t_err, _ = judge.motion_errors(np.stack(P[-2:]), truth[k - 1:k + 1])
        step_mm = float(t_err[0]) * 1e3
        pose_mm = float(np.linalg.norm(jT[:3, 3] - truth[k][:3, 3])) * 1e3
        _, lo = pipeline.step_eager(pcfg, interop.state_from_numpy(before, "cpu"), pts[k], msk[k], dt * k)
        lT = lo.odom.T.numpy()
        jl, ll = np.asarray(jo.detections.labels), lo.detections.labels.numpy()
        ref = components.compare(pcfg.detection, ll, se3.transform_points(lo.odom.T, pts[k]).numpy(),
                                 msk[k].numpy(), lT[:3, 3])
        print(json.dumps(dict(
            seed=args.seed, step=k, lap_scan=int(scans[k]),
            lock_mm=float(np.abs(lT[:3, 3] - jT[:3, 3]).max()) * 1e3, lock_mrad=_rot_mrad(lT, jT),
            lock_kf_equal=bool(lo.keyframe_added) == bool(jo.keyframe_added), step_mm=step_mm,
            pose_mm=pose_mm,
            labels_vs_jax=int((ll != jl).sum()),
            roots_equal=_roots(ll, lo.detections.pixel_slot.numpy()) == _roots(jl, np.asarray(jo.detections.pixel_slot)),
            labels_vs_reference=ref,
            objects=[int(np.asarray(jo.detections.objects.valid).sum()), int(lo.detections.objects.valid.sum())],
            jax_s=round(t_jax, 1), s=round(time.time() - t0, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
