"""Read the numbers the reference compares for the program, its control
and the faults, on the card at a cell's own size; the limits in
``cardbench/limits/`` are set from these readings. The benchmark's own
runs do not run this.

    python cardbench/controls.py --workload <cell> --seeds 11 12 13

For each seed, one process renders the lap, sets up as a run does
(capture, one lap) and then drives, from that same state, the judged lap
of a window (untimed):

- ``program``: the timed path as it is;
- each fault the cell can have, planted in the timed path (the entry
  wrapped): ``state_unchanged`` (the step returns the state it was
  given), ``half_batch`` (a fleet's second half of streams given the
  first half's results), ``pose_altered`` (5 cm added to every other
  pose's x), ``mask_altered`` (the dynamic mask inverted), ``tracks_altered``
  (every track's class set to undefined), ``flag_altered`` (the
  keyframe flag inverted);
- ``control``: the program in the precision below the configuration's
  (float32 with TF32 off, PyTorch's default): its float32 matrix
  products in TF32 (``torch.backends.cuda.matmul.allow_tf32``), from its
  first scan, its graph captured anew.

Prints one JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
UNDEFINED = 0


def _faults(streams: int) -> dict:
    import torch

    from dynamic_direct_lidar_odometry_tpu_torch.core import tree

    def state_unchanged(entry):
        return lambda st, *a: (st, entry(st, *a)[1])

    def half_batch(entry):
        def run(st, *a):
            out = entry(st, *a)
            h = streams // 2
            return tree.map_leaves(lambda t: torch.cat([t[:h], t[:h]]) if torch.is_tensor(t) else t, out)
        return run

    def pose_altered(entry):
        calls = [0]

        def run(st, *a):
            st, out = entry(st, *a)
            calls[0] += 1
            T = out.odom.T.clone()
            T[..., 0, 3] += 0.05 * (calls[0] % 2)
            return st, out._replace(odom=out.odom._replace(T=T))
        return run

    def mask_altered(entry):
        def run(st, *a):
            st, out = entry(st, *a)
            return st, out._replace(dynamic_mask=~out.dynamic_mask)
        return run

    def tracks_altered(entry):
        def run(st, *a):
            st, out = entry(st, *a)
            return st._replace(tracks=st.tracks._replace(
                status=torch.full_like(st.tracks.status, UNDEFINED))), out
        return run

    def flag_altered(entry):
        def run(st, *a):
            st, out = entry(st, *a)
            return st, out._replace(keyframe_added=~out.keyframe_added)
        return run

    faults = dict(state_unchanged=state_unchanged, pose_altered=pose_altered,
                  mask_altered=mask_altered, tracks_altered=tracks_altered,
                  flag_altered=flag_altered)
    if streams > 1:
        faults["half_batch"] = half_batch
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))

    import torch

    import harness

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload, ROOT)

    def emit(seed, kind, numbers, drv):
        print(json.dumps(dict(workload=cell.name, seed=seed, kind=kind, numbers=numbers,
                              judged_steps=len(drv.rec.T) - drv.rec.window_first,
                              window_steps=len(drv.rec.latency_s))), flush=True)

    for seed in args.seeds:
        feed = harness.make_feed(cell, seed, dev)
        drv = harness.Driver(cell, feed, dev)
        drv.setup()
        snap = drv.snapshot()
        drv.window(0)
        emit(seed, "program", harness.judge_run(cell, feed, drv.rec), drv)
        for name, wrap in _faults(feed.streams).items():
            drv.restore(snap)
            entry = drv.entry
            drv.entry = wrap(entry)
            drv.window(0)
            drv.entry = entry
            emit(seed, name, harness.judge_run(cell, feed, drv.rec), drv)
        drv.release()
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = harness.Driver(cell, feed, dev)
            ctl.setup()
            ctl.window(0)
            emit(seed, "control", harness.judge_run(cell, feed, ctl.rec), ctl)
            ctl.release()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return 0


if __name__ == "__main__":
    sys.exit(main())
