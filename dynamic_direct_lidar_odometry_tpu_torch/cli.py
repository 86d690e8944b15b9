"""Command-line interface of the port: run / synth / convert
(counterpart of ``cli.py``; the reference's roslaunch surface,
``launch/ddlo.launch``, as one process: a dataset in; the TUM trajectory,
object trajectories, map PCD, timing dashboard and optional evaluation
dumps and checkpoints out).

  python -m dynamic_direct_lidar_odometry_tpu_torch.cli run \\
      --dataset seq.npz --out results/ [--device cpu]

  python -m dynamic_direct_lidar_odometry_tpu_torch.cli synth \\
      --scans 40 --out seq.npz

  python -m dynamic_direct_lidar_odometry_tpu_torch.cli convert \\
      --bag kantplatz.bag --topic /points --rows 512 --cols 512 --out seq.npz

``run`` takes the JAX CLI's arguments plus ``--device`` (default
``cuda``: the card, which it needs unless told ``--device cpu``) and
replays with the device hulls (``runner.replay``'s default).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def run_config(H: int, W: int, config_path: str | None = None, dynamic: bool = True):
    """The configuration ``run`` replays an H x W dataset with: the YAML
    at ``config_path``, else the DOALS preset scaled to the scan, with
    capacities from ``capacity_for_scan`` (the JAX CLI's, cli.py:31-59)."""
    from dynamic_direct_lidar_odometry_tpu_torch import config as cfg_lib

    if config_path:
        cfg = cfg_lib.load_config(config_path)
    else:
        cfg = cfg_lib.doals_config()
        # the DOALS preset assumes a 2048-column scan (cfg/DOALS.yaml:
        # downsampling col=10, keyframe threshD=5); scale both to the
        # dataset's geometry so the preset stays usable as the default
        col = max(1, W // 256)
        cfg = dataclasses.replace(
            cfg,
            preprocessing=dataclasses.replace(
                cfg.preprocessing,
                downsampling=dataclasses.replace(cfg.preprocessing.downsampling, col=col),
            ),
            keyframe=dataclasses.replace(cfg.keyframe, thresh_dist=1.0),
        )
    return dataclasses.replace(
        cfg,
        dynamic_detection=dynamic,
        detection=dataclasses.replace(cfg.detection, rows=H, columns=W),
        capacity=cfg_lib.capacity_for_scan(H, W),
    )


def _cmd_run(args: argparse.Namespace) -> int:
    from dynamic_direct_lidar_odometry_tpu_torch import runner
    from dynamic_direct_lidar_odometry_tpu_torch.io.dataset import ScanSequence

    seq = ScanSequence.load(args.dataset)
    cfg = run_config(seq.H, seq.W, args.config, dynamic=not args.no_dynamic)
    res = runner.replay(
        cfg,
        seq,
        out_dir=args.out,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        evaluate=args.evaluate,
        progress=not args.quiet,
        dashboard_every=args.dashboard_every,
        viz_every=args.viz_every,
        save_every=args.save_every,
        export_clouds_every=args.export_clouds_every,
        device=args.device,
    )
    print(res.profiler.dashboard())
    print(
        f"scans={len(res.poses)} keyframes={res.num_keyframes} "
        f"map_points={res.map_points}"
    )
    if seq.gt_poses is not None:
        ate = runner.ate_rmse(
            res.poses, seq.gt_poses, est_stamps=res.stamps, gt_stamps=seq.stamps,
        )
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
    return 0


def _cmd_synth(args: argparse.Namespace) -> int:
    from dynamic_direct_lidar_odometry_tpu_torch.io import dataset

    seq = dataset.synthetic_sequence(
        n_scans=args.scans, H=args.rows, W=args.cols,
        n_dynamic=args.dynamic, seed=args.seed,
    )
    seq.save(args.out)
    print(f"wrote {args.out}: {len(seq)} scans of {seq.H}x{seq.W}")
    return 0


def _cmd_convert(args: argparse.Namespace) -> int:
    from dynamic_direct_lidar_odometry_tpu_torch.io import dataset

    dataset.convert_rosbag(args.bag, args.topic, args.rows, args.cols, args.out)
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ddlo-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="replay a dataset through the pipeline")
    run.add_argument("--dataset", required=True)
    run.add_argument("--config", default=None,
                     help="reference-format YAML (cfg/ddlo.yaml style)")
    run.add_argument("--out", default=None)
    run.add_argument("--no-dynamic", action="store_true",
                     help="plain DLO (dynamicDetection=false)")
    run.add_argument("--evaluate", action="store_true",
                     help="dump per-frame dynamic indices "
                          "(detection.cpp:936-954 format)")
    run.add_argument("--checkpoint-every", type=int, default=0)
    run.add_argument("--resume", default=None)
    run.add_argument("--quiet", action="store_true")
    run.add_argument("--dashboard-every", type=int, default=0,
                     help="print the debug dashboard every N scans "
                          "(odom.cc:1317-1461)")
    run.add_argument("--save-every", type=int, default=0,
                     help="periodic map+trajectory snapshot every N scans "
                          "(SIGUSR1 requests one on demand)")
    run.add_argument("--export-clouds-every", type=int, default=0,
                     help="export per-stage intermediate clouds (residual/"
                          "static/keyframes PCDs) every N scans")
    run.add_argument("--viz-every", type=int, default=0,
                     help="write range/residual/label debug images every "
                          "N scans (detection.cpp:834-909)")
    run.add_argument("--device", default="cuda",
                     help="torch device to run on (default: the card)")
    run.set_defaults(fn=_cmd_run)

    synth = sub.add_parser("synth", help="generate a synthetic sequence")
    synth.add_argument("--scans", type=int, default=40)
    synth.add_argument("--rows", type=int, default=64)
    synth.add_argument("--cols", type=int, default=1024)
    synth.add_argument("--dynamic", type=int, default=2)
    synth.add_argument("--seed", type=int, default=0)
    synth.add_argument("--out", required=True)
    synth.set_defaults(fn=_cmd_synth)

    conv = sub.add_parser("convert", help="convert a rosbag")
    conv.add_argument("--bag", required=True)
    conv.add_argument("--topic", required=True)
    conv.add_argument("--rows", type=int, required=True)
    conv.add_argument("--cols", type=int, required=True)
    conv.add_argument("--out", required=True)
    conv.set_defaults(fn=_cmd_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
