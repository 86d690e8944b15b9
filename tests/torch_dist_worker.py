"""One rank of the port's multi-process CPU tests (``torch.distributed``,
gloo), started N times by tests/test_torch_distributed.py and
tests/test_torch_point_parallel.py. Imports neither ``jax`` nor the JAX
package: the JAX references and the shared inputs come from the test
process through ``--inputs``.

Modes:
- ``dp``: tests/multihost_worker.py's batch (8 registrations of 256
  points), dp over the processes: each process computes the covariances
  of its own slice, aligns it, and the poses are gathered to rank 0.
- ``align_pt``: ``sharding.batched_align(point_sharded=True)`` of the
  batch in ``--inputs`` over a pt group of every rank.
- ``pipe_pt``: ``sharding.point_parallel_pipeline_step`` of the tiny
  config (tests/test_parallel.py's ``_tiny_cfg``) on the scan in
  ``--inputs``, pt over every rank.
- ``agree``: ``distributed.check_agree`` over a pt group of every rank,
  on a state that all ranks hold and on one whose leaf differs on rank 1.

Every rank writes ``<out>.<rank>.npz``.
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch import config as cfg_lib
from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, gicp
from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed, sharding


def tiny_cfg():
    cfg = cfg_lib.doals_config()
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, rows=8, columns=64, ground_rows=2),
        capacity=cfg_lib.CapacityConfig(
            max_points=512, max_submap_points=2048, max_keyframes=8,
            max_keyframe_points=512, max_objects=4, max_tracks=4, nn_chunk=128,
        ),
    )


def flat(tree, prefix="", out=None):
    """Every tensor leaf of a container, keyed by its path."""
    out = {} if out is None else out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), f"{prefix}.{f}", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    return out


def run_dp(args, out):
    B, N = 8, 256
    rng = np.random.default_rng(42)
    src = rng.uniform(-10, 10, (B, N, 3)).astype(np.float32)
    dT = rng.uniform(-0.05, 0.05, (B, 1, 3)).astype(np.float32)
    tgt = (src + dT).astype(np.float32)
    mask = np.ones((B, N), bool)
    mesh = distributed.global_mesh(pt=1, device="cpu")
    sl = distributed.process_batch_slice(B)

    def covs(p, m):
        return torch.stack([covariance.plane_covariances(torch.from_numpy(a), torch.from_numpy(b), k=10)
                            for a, b in zip(p, m)]).numpy()

    local = {
        "src": src[sl], "smask": mask[sl], "scovs": covs(src[sl], mask[sl]),
        "tgt": tgt[sl], "tmask": mask[sl], "tcovs": covs(tgt[sl], mask[sl]),
        "guess": np.tile(np.eye(4, dtype=np.float32), (sl.stop - sl.start, 1, 1)),
    }
    g = distributed.make_global_batch(mesh, local)
    align = sharding.batched_align(mesh, gicp.GICPSettings(max_iterations=8, compute_residuals=False))
    res = align(g["src"], g["smask"], g["scovs"], g["tgt"], g["tmask"], g["tcovs"], g["guess"])
    out["T"] = distributed.allgather_rows(res.T, None).numpy()
    out["converged"] = distributed.allgather_rows(res.converged, None).numpy()


def run_align_pt(args, out):
    z = np.load(args.inputs)
    mesh = sharding.make_mesh(args.nproc, pt=args.nproc, devices=["cpu"])
    align = sharding.batched_align(mesh, gicp.GICPSettings(max_iterations=16), point_sharded=True)
    res = align(*(z[k] for k in ("src", "m", "covs", "tgt", "tm", "tcovs", "guess")))
    out.update(flat(res, "res"))


def run_pipe_pt(args, out):
    z = np.load(args.inputs)
    cfg = tiny_cfg()
    mesh = sharding.make_mesh(args.nproc, pt=args.nproc, devices=["cpu"])
    pts, mask = z["pts"][None], z["mask"][None]
    states = sharding.batched_init_state(cfg, pts, mask, np.zeros(1, np.float32), device="cpu")
    step = sharding.point_parallel_pipeline_step(cfg, mesh)
    new_states, outputs = step(states, pts, mask, np.full(1, 0.1, np.float32))
    out.update(flat(new_states, "state"))
    out.update(flat(outputs, "out"))


def run_agree(args, out):
    group = sharding.make_mesh(args.nproc, pt=args.nproc, devices=["cpu"]).pt_group
    distributed.check_agree((torch.eye(4), None, [torch.arange(5)]), group)
    try:
        distributed.check_agree((torch.eye(4), None, [torch.arange(5) + int(args.pid == 1)]), group)
        out["raised"] = np.array(False)
    except RuntimeError as e:
        out["raised"] = np.array("diverged" in str(e))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True, choices=["dp", "align_pt", "pipe_pt", "agree"])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--inputs", default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    distributed.initialize(args.coordinator, args.nproc, args.pid, backend="gloo")
    out = {}
    {"dp": run_dp, "align_pt": run_align_pt, "pipe_pt": run_pipe_pt,
     "agree": run_agree}[args.mode](args, out)
    np.savez(f"{args.out}.{args.pid}.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
