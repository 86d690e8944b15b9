"""The batch modes as one device program: ``gicp.align_batch``'s loops on
``core/control.py``, ``sharding.batched_align`` and
``sharding.batched_pipeline_step`` (and ``replay.replay_batch`` on it) as
captured graphs on the card, their B streams B branches of one graph.

On the CPU:
- ``align_batch`` bit for bit against ``tests/golden/torch_align_batch_cpu.npz``
  (written by ``tools/torch_align_batch_golden.py`` from the loops as
  they were driven from the host): tests/test_torch_parallel.py's four
  cases, the LM loops with ``record_trace``, and the card's path on the
  host (its arithmetic and the batched sparse 1-NN's plain version);
- ``align_batch`` under tests/test_torch_sync_free.py's host-read guard,
  both optimizers: its loops read only their predicates;
- the eager ``batched_pipeline_step`` bit for bit against B single
  ``pipeline.step`` calls, every leaf after every scan;
- the device counts' branch rows.

The ``gpu`` cases skip without a card. This module imports no JAX at its
top, so they also run on a host without it:
``python -m pytest --noconftest tests/test_torch_batch_graph.py -m gpu``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dynamic_direct_lidar_odometry_tpu_torch import config, pipeline
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core import tree
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp
from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_align_batch_cpu.npz")
CPU = sharding.make_mesh(1, devices=["cpu"])


def _golden():
    z = np.load(GOLDEN)
    return z, json.loads(str(z["cases"]))


def _case(name, dev="cpu"):
    """(inputs, settings, card path) of a golden case."""
    z, cases = _golden()
    c = cases[name]
    n_in = len([k for k in z.files if k.startswith(f"in/{c['inputs']}/")])
    args = [torch.from_numpy(z[f"in/{c['inputs']}/{i}"]).to(dev) for i in range(n_in)]
    return args, gicp.GICPSettings(**c["settings"]), c["card_path"]


def _card_path(mp):
    """The card's branches on CPU tensors: the kernels' plain versions and
    GICP's card arithmetic."""
    mp.setattr(device_mod, "on_accelerator", lambda t: True)
    mp.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)


def _bits(x: torch.Tensor) -> bytes:
    return x.detach().cpu().contiguous().numpy().tobytes()


def _differ(a, b, path="") -> list:
    """Paths of the leaves of two containers that differ in any bit."""
    if a is None or b is None:
        return [] if a is None and b is None else [path]
    if tree.is_namedtuple(a):
        return [p for f in a._fields for p in _differ(getattr(a, f), getattr(b, f), f"{path}.{f}")]
    if isinstance(a, (tuple, list)):
        return [p for i, (u, v) in enumerate(zip(a, b)) for p in _differ(u, v, f"{path}[{i}]")]
    same = a.shape == b.shape and a.dtype == b.dtype and _bits(a) == _bits(b)
    return [] if same else [path]


@pytest.mark.parametrize("case", list(_golden()[1]))
def test_align_batch_matches_the_golden(case, monkeypatch):
    args, s, card = _case(case)
    if card:
        _card_path(monkeypatch)
    res = gicp.align_batch(*args, s)
    z, _ = _golden()
    for f in res._fields:
        want = z[f"out/{case}/{f}"]
        got = getattr(res, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_align_batch_loops_read_only_predicates(optimizer, monkeypatch):
    """The varied case (6 streams of 256 points, one degenerate) on the
    card's path, record_trace on: the guard raises on any host read but
    the eager driver's predicate reads."""
    from test_torch_sync_free import no_host_reads

    args, _, _ = _case("varied")
    s = gicp.GICPSettings(max_iterations=8, optimizer=optimizer, record_trace=True,
                          nn_impl="sparse", max_correspondence_distance=2.0)
    _card_path(monkeypatch)
    want = gicp.align_batch(*args, s)
    control.PREDICATE_READS.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the guard runs Python around every op
    try:
        with no_host_reads():
            got = gicp.align_batch(*args, s)
    finally:
        torch.set_num_threads(n)
    assert not _differ(got, want)
    passes = int(got.iterations.max())
    assert passes > 1 and control.PREDICATE_READS["while"] > passes


def tiny_cfg():
    """tests/test_torch_parallel.py's tiny configuration, in the port."""
    cfg = config.doals_config()
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, rows=16, columns=128, ground_rows=4),
        capacity=config.CapacityConfig(
            max_points=512, max_submap_points=2048, max_keyframes=8,
            max_keyframe_points=512, max_objects=4, max_tracks=4, nn_chunk=128,
        ),
    )


def _streams(B, S):
    seqs = [dataset.synthetic_sequence(n_scans=S, H=16, W=128, n_dynamic=0, seed=i)
            for i in range(B)]
    return (np.stack([q.points for q in seqs]), np.stack([q.mask for q in seqs]),
            np.stack([q.stamps for q in seqs]).astype(np.float32))


def _batched_vs_single(dev, B=2, S=3):
    """Per scan, the batched step's every leaf against B single
    ``pipeline.step`` runs; returns the differing paths by (scan, stream)."""
    cfg = tiny_cfg()
    pts, msk, ts = _streams(B, S)
    mesh = CPU if dev == "cpu" else sharding.make_mesh()
    states = sharding.batched_init_state(cfg, pts[:, 0], msk[:, 0], ts[:, 0], device=dev)
    singles = [pipeline.init_state(cfg, pts[b, 0], msk[b, 0], float(ts[b, 0]), device=dev)
               for b in range(B)]
    step = sharding.batched_pipeline_step(cfg, mesh)
    differ = {}
    for s in range(1, S):
        states, outs = step(states, pts[:, s], msk[:, s], ts[:, s])
        for b in range(B):
            singles[b], out = pipeline.step(cfg, singles[b], pts[b, s], msk[b, s],
                                            torch.tensor(ts[b, s]))
            d = _differ((tree.index(states, b), tree.index(outs, b)), (singles[b], out))
            if d:
                differ[(s, b)] = d
    return differ, states


def test_cpu_batched_step_equals_single_steps():
    from test_torch_parallel import _tiny_cfg
    from torch_parity import port_cfg

    assert tiny_cfg() == port_cfg(_tiny_cfg())
    differ, states = _batched_vs_single("cpu", B=2, S=3)
    assert not differ
    assert states.odom.T.shape == (2, 4, 4)


def test_count_rows_sum_on_read():
    """A graph branch counts into a row of its own; a read sums the rows."""
    with profiling.device_counts("cpu") as got:
        profiling.count("cpu", "test_rows", 2)
        with profiling.count_row(3):
            profiling.count("cpu", "test_rows", torch.tensor(5))
        with profiling.count_row(profiling.MAX_COUNT_ROWS - 1):
            profiling.count("cpu", "test_rows")
    assert got["test_rows"] == 8
    with pytest.raises(ValueError):
        with profiling.count_row(profiling.MAX_COUNT_ROWS):
            pass


def test_branches_run_in_turn_off_a_capture():
    order = []
    out = control.branches("cpu", 3, lambda b: order.append(b) or b * b)
    assert out == [0, 1, 4] and order == [0, 1, 2]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sync_free(fn, *args):
    """``fn(*args)`` with every synchronizing CUDA call an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_two_branches_with_while_nodes_on_the_card():
    """Two branches of one graph, each a WHILE loop that counts its turns
    on the device into the same key: equal to the eager driver on several
    inputs, exact counts (a row per branch), no synchronization."""
    dev = _card()

    def fn(x0, m):
        def one(b):
            x, j = x0[b].clone(), torch.zeros((), dtype=torch.int32, device=dev)

            def body(x, j):
                x.copy_(torch.sin(x) * 1.25 + 0.1 * b)
                profiling.count(dev, "test_branch_turns")
                j.add_(1)

            control.while_loop(lambda x, j: j < m[b], body, (x, j))
            return x, j

        outs = control.branches(dev, 2, one)
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    x0 = torch.linspace(-1.0, 1.0, 2 * 4096, device=dev).reshape(2, 4096)
    g = None
    for m in ((0, 3), (5, 1), (40, 37)):
        mt = torch.tensor(m, dtype=torch.int32, device=dev)
        ref = fn(x0, mt)
        g = g or control.Graph(fn, (x0, mt), branches=2)
        with profiling.device_counts(dev) as got:
            out = _sync_free(g, x0, mt)
        assert not _differ(out, ref)
        assert got.get("test_branch_turns", 0) == sum(m)


@pytest.mark.gpu
def test_batched_align_graph_matches_eager_on_the_card():
    """``batched_align`` on the card replays a graph of ``align_batch``:
    every field bit-equal to the eager call, one batched sparse launch
    per batched linearization and no single-stream one."""
    dev = _card()
    args, _, _ = _case("varied", dev)
    s = gicp.GICPSettings(max_iterations=16, record_trace=True, nn_impl="sparse",
                          max_correspondence_distance=2.0)
    want = gicp.align_batch(*args, s)
    sharding.clear_graphs()
    aligner = sharding.batched_align(sharding.make_mesh(), s)
    aligner(*args)  # captures
    with profiling.device_counts(dev) as got:
        res = _sync_free(aligner, *args)
    assert not _differ(res, want)
    lin = int(res.iterations.max()) + 1
    assert got.get("nn1_sparse_batched") == lin and "nn1_sparse" not in got, got
    assert [g["kind"] for g in sharding.graph_stats()] == ["align"]


@pytest.mark.gpu
def test_batched_step_graph_matches_single_graph_steps_on_the_card():
    """The batched step (one graph, two branches) against two single
    graph steps: every leaf of every state and output, after every scan."""
    dev = _card()
    sharding.clear_graphs()
    differ, _ = _batched_vs_single(dev, B=2, S=3)
    assert not differ, differ
    (g,) = sharding.graph_stats()
    assert g["kind"] == "step" and g["replays"] == 2
