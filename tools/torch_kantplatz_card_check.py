"""The kantplatz deployment on the card over ``k4a-walk``, as the
benchmark would run its cell: the set-up lap, then the judged lap, each
step a ``pipeline.step`` graph replay with the pose read on the host.
At the judged steps that slip, the program is held to its plain versions at
this deployment's sizes (65,536 registration points, a 262,144-point
submap, K = 256 candidates, 128 keyframes):

- the graph step against ``pipeline.step_eager`` from a copy of the same
  state: every output and state tensor bit-equal;
- every ``nn1_sparse_chunks`` call of that eager step against
  ``nn1_sparse_reference`` on the same lists;
- every lambda loop (``gicp.lm_inner``; above 28,672 points its
  device-memory route) against ``lm_inner_plain``;
- every ``segment_objects`` call against ``segment_objects_plain``;

at the end of the run the keyframe store's blocked (K = 128) convex and
concave hull masks against the host's; and every third judged scan's
``label_components`` labels against the plain reference,
``cardbench/reference/components.py`` (``compare``: a pixel may differ
only in a component that touches an edge within one float32 ulp of
theta).

    python3 tools/torch_kantplatz_card_check.py --seeds 3000000021 17179869261
    python3 tools/torch_kantplatz_card_check.py --seeds 3000000021 --render cpu --tf32 --no-check

One JSON line per seed: the judge's numbers (``cardbench/reference/
judge.py`` on the judged lap), the judged lap's worst steps (lap scan,
mm, mrad) and the set-up's (lap scan, step, mm, mrad), the keyframes
stored and the checks. ``--tf32``: matrix products in TF32
(``cardbench/controls.py``'s control); ``--no-movers``: the truth's
movers taken out of every scan (a witness: what GICP does without
them); ``--render cpu``: the lap rendered on the host, whose range noise
is the CPU's draw, so that the card steps the scans
``tools/torch_kantplatz_lockstep.py`` gives the JAX package
(``render_sha256`` names them); ``--save DIR``: the first checked
step's ``gicp.align`` calls, inputs and results on the card, with the
poses before and after, to ``DIR/kantplatz_align_<seed>_<step>.npz``
(``tools/torch_kantplatz_lockstep.py --align`` runs them in both
packages on the CPU). The checks use ``chip_smoke.py``'s comparisons.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "cardbench"), os.path.join(ROOT, "cardbench", "reference")]

WORKLOAD = "kantplatz.stream1"


def save_aligns(path, calls, **extra) -> None:
    """The step's ``gicp.align`` calls (S2S, then S2M), their inputs and
    results on the card, into ``path`` (``.npz``), with ``extra`` arrays."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    names = ("src_pts", "src_mask", "src_covs", "tgt_pts", "tgt_mask", "tgt_covs", "guess")
    out = dict(extra)
    for i, (a, kw) in enumerate(calls):
        settings = a[7] if len(a) > 7 else kw.get("settings", gicp.GICPSettings())
        for n, x in zip(names, a[:7]):
            out[f"{i}_{n}"] = x.cpu().numpy()
        r = gicp.align(*a[:7], settings)
        out[f"{i}_T"] = r.T.cpu().numpy()
        out[f"{i}_iterations"] = r.iterations.cpu().numpy()
        out[f"{i}_settings"] = np.array(json.dumps(settings._asdict()))
    np.savez_compressed(path, calls=np.int64(len(calls)), **out)


def eager_checks(cfg, prev, p, m, t, graph_state, graph_out, save=None, truth=()) -> dict:
    """The graph step against ``step_eager`` from ``prev``, and the eager
    step's kernels against their plain versions; ``save``: a path for
    the step's ``gicp.align`` calls (:func:`save_aligns`), with the
    ``truth`` poses before and after."""
    import chip_smoke as cs
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, nn_cuda, segmentation

    with cs.recorded_calls(nn_cuda, "nn1_sparse_chunks", clone=True) as nn_calls, \
            cs.recorded_trials() as trials, \
            cs.recorded_calls(gicp, "align", clone=True) as aligns, \
            cs.recorded_calls(segmentation, "segment_objects", clone=True) as seg_calls:
        st, out = pipeline.step_eager(cfg, prev, p, m, t)
    res = dict(graph_vs_eager=cs._bits_differ((graph_state, graph_out), (st, out)))
    if save:
        save_aligns(save, aligns, P0=prev.odom.T.cpu().numpy(), P1=out.odom.T.cpu().numpy(),
                    G0=truth[0], G1=truth[1])
        res["saved"] = os.path.basename(save)
    off = []
    for i, (a, _) in enumerate(nn_calls):
        ik, dk = nn_cuda.nn1_sparse_chunks(*a)
        ir, dr = nn_cuda.nn1_sparse_reference(*a)
        if not (torch.equal(ik, ir) and torch.equal(dk, dr)):
            off.append(i)
    res["nn1_sparse"] = dict(calls=len(nn_calls), not_bit_equal=off,
                             shapes=sorted({(tuple(a[0].shape), tuple(a[1].shape)) for a, _ in nn_calls}))
    loops = [(f"loop_{i}", (list(ins), s)) for i, (ins, s) in enumerate(trials["inner"])]
    for name, cases, fn in (("lm_inner", loops, cs.check_lm_inner),
                            ("segment_objects", [(f"call_{i}", a, kw) for i, (a, kw) in enumerate(seg_calls)],
                             cs.check_segment_objects)):
        try:
            rec = fn(cases, "kantplatz_slip") if cases else {}
            res[name] = dict(calls=len(cases), not_bit_equal=rec.get("cases_not_bit_equal", []),
                             **({"points": sorted({int(c[1][0][4].shape[-2]) for c in cases})} if name == "lm_inner" else {}))
        except cs.SmokeFailure as e:
            res[name] = dict(calls=len(cases), failed=str(e))
    return res


def render_sha256(points, mask) -> str:
    """sha256 of a lap's points and mask, in lap order, as rendered."""
    import hashlib

    h = hashlib.sha256()
    h.update(points.cpu().numpy().tobytes())
    h.update(mask.cpu().numpy().tobytes())
    return h.hexdigest()


def hull_check(state) -> dict:
    """The store's hull masks on the card against the host's."""
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf

    store = state.odom.store
    pos, valid, alpha = store.positions, store.valid, state.odom.keyframe_thresh_dist
    card = (kf.convex_hull_mask(pos, valid), kf.concave_hull_mask(pos, valid, alpha))
    host = (kf.convex_hull_mask(pos.cpu(), valid.cpu()), kf.concave_hull_mask(pos.cpu(), valid.cpu(), alpha.cpu()))
    return dict(K=int(pos.shape[0]), valid=int(valid.sum()), convex=int(card[0].sum()), concave=int(card[1].sum()),
                card_equals_host=all(torch.equal(a.cpu(), b) for a, b in zip(card, host)))


def run(seed: int, args) -> dict:
    import harness
    import torch
    from reference import judge

    from dynamic_direct_lidar_odometry_tpu_torch.core import se3, tree

    dev = torch.device("cuda", 0)
    cell = harness.resolve(harness.load_benchmark(Path(ROOT)), WORKLOAD, Path(ROOT))
    t0 = time.time()
    feed = harness.make_feed(cell, seed, args.render or dev)
    lap_order = np.argsort(feed.order)
    render = render_sha256(feed.points[lap_order], feed.mask[lap_order])
    if args.render:  # the truth the judge reads, on the card
        feed.valid, feed.mover, feed.visible = (x.to(dev) for x in (feed.valid, feed.mover, feed.visible))
    if args.no_movers:
        feed.mask &= (feed.mover[torch.as_tensor(feed.order, device=dev)] < 0).cpu()
    drv = harness.Driver(cell, feed, dev)
    real, checks, judged, scans = drv.entry, [], [], []

    def entry(st, p, m, t):
        keep = judged and not args.no_check and len(checks) < args.max_checks
        prev = tree.map_leaves(torch.clone, st) if keep else None
        new, out = real(st, p, m, t)
        j = drv.j
        if judged and not args.no_check and (j - drv.rec.window_first) % 3 == 0:
            T = out.odom.T
            scans.append((se3.transform_points(T, p.to(dev)).cpu().numpy(), m.cpu().numpy(),
                          T[:3, 3].cpu().numpy(), out.detections.labels.cpu().numpy()))
        if prev is None:
            return new, out
        i0, i1 = feed.lap_index(j - 1)[0], feed.lap_index(j)[0]
        t_err, r_err = judge.motion_errors(np.stack([drv.rec.T[-1][0], out.odom.T.cpu().double().numpy()]),
                                           feed.poses[[i0, i1]])
        mm, mrad = float(t_err[0]) * 1e3, float(r_err[0]) * 1e3
        if mm > args.slip_mm:
            save = None
            if args.save and not checks:
                save = os.path.join(args.save, f"kantplatz_align_{seed}_{j}.npz")
            res = eager_checks(drv.cfg, prev, p, m, t, new, out, save, feed.poses[[i0, i1]])
            checks.append(dict(step=j, lap_scan=int(i1), mm=mm, mrad=mrad, **res))
        return new, out

    drv.entry = entry
    for _ in range(feed.lap + 1):
        drv.step()
    drv.begin_window()
    judged.append(True)
    while drv.j < drv.rec.judged(feed.lap).stop:
        drv.step(keep=True)
    rec = drv.rec
    numbers = harness.judge_run(cell, feed, rec)
    first, end = rec.judged(feed.lap).start, rec.judged(feed.lap).stop
    P, idx = np.stack(rec.T)[:end], np.stack(rec.lap_idx)[:end]
    t, r = judge.motion_errors(P[first - 1:, 0], feed.poses[idx][first - 1:, 0])
    worst = [(int(idx[first + k, 0]), round(float(t[k]) * 1e3, 1), round(float(r[k]) * 1e3, 1))
             for k in np.argsort(-t)[:10]]
    ts, rs = judge.motion_errors(P[:first, 0], feed.poses[idx][:first, 0])  # the set-up's steps
    setup_worst = [(int(idx[1 + k, 0]), int(1 + k), round(float(ts[k]) * 1e3, 1), round(float(rs[k]) * 1e3, 1))
                   for k in np.argsort(-ts)[:5]]
    out = dict(seed=seed, tf32=args.tf32, no_movers=args.no_movers, render=args.render or "cuda",
               render_sha256=render, numbers=numbers, worst=worst, setup_worst=setup_worst,
               keyframes=int(drv.state.odom.store.count.item()), checks=checks,
               hulls=None if args.no_check else hull_check(drv.state))
    drv.release()
    if scans:
        import components

        got = [components.compare(drv.cfg.detection, lab, w, m, o) for w, m, o, lab in scans]
        out["labels"] = dict(scans=len(got), scans_differ=sum(g["differ"] > 0 for g in got),
                             pixels_differ=sum(g["differ"] for g in got),
                             near_theta=sum(g["near_theta"] for g in got),
                             unexplained=sum(g["unexplained"] for g in got))
    out["s"] = round(time.time() - t0, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--tf32", action="store_true", help="matrix products in TF32 (the control)")
    ap.add_argument("--no-movers", action="store_true", help="the truth's movers out of every scan")
    ap.add_argument("--no-check", action="store_true", help="the run and the judge's numbers only")
    ap.add_argument("--render", choices=["cpu"], help="render the lap on the host (the scans the CPU tools see)")
    ap.add_argument("--save", help="a folder for the first checked step's gicp.align calls")
    ap.add_argument("--slip-mm", type=float, default=100.0, help="check the steps that slip by more")
    ap.add_argument("--max-checks", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if args.tf32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    failed = False
    for seed in args.seeds:
        res = run(seed, args)
        bad = [c for c in res["checks"] if c["graph_vs_eager"] or c["nn1_sparse"]["not_bit_equal"]
               or any(c[k].get("not_bit_equal") or c[k].get("failed") for k in ("lm_inner", "segment_objects"))]
        failed |= bool(bad) or (res["hulls"] is not None and not res["hulls"]["card_equals_host"])
        failed |= bool(res.get("labels", {}).get("unexplained"))
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
