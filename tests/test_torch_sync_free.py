"""The bodies that a captured graph runs read nothing back to the host.

Each restructured body (the LM loops of ``gicp.align``, the CCL sweep of
``segmentation.label_components``, the keyframe insert with its eviction
at capacity, ``keyframes.gather_submap``, and a whole ``pipeline`` step
on the accelerator paths) runs on the CPU under a guard that raises on
every host read: ``Tensor.__bool__``, ``__int__``, ``__float__``,
``__index__``, ``.item()``, ``.tolist()``, and the ATen operations that
synchronize on a CUDA device (``nonzero``, ``masked_select``, ``unique``,
``bincount``, ``equal``, boolean indexing, a checked ``segment_reduce``,
``torch.tensor`` of host data). The guard lets through only the CPU's
own host arithmetic (``ops/gicp_xla.py``, the exact sweeps of
``ops/knn.py``), the kernels' plain versions, and the eager driver's
predicate read (``core/control.read_predicate``). A host read put back
into one of these bodies fails here, without a GPU.

The gather and insert cases are also held bit-equal to the JAX package.
"""

import collections
import contextlib
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_approximations import random_trajectory_positions
from test_kantplatz import small_kantplatz
from test_torch_gicp import _pair
from torch_parity import n, port_accelerator_paths, port_cfg, render_seq, small_cfg, t

from dynamic_direct_lidar_odometry_tpu.odometry import keyframes as jkf
from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf
from dynamic_direct_lidar_odometry_tpu_torch.odometry import odometry
from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, gicp, gicp_xla, hungarian
from dynamic_direct_lidar_odometry_tpu_torch.ops import knn as knn_ops
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda, segmentation
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling


class HostRead(AssertionError):
    pass


# host code that runs only on the CPU: XLA's host arithmetic, the exact
# sweeps, and the plain versions that stand in for the card's kernels
_ALLOWED_FILES = {gicp_xla.__file__, knn_ops.__file__}
_ALLOWED_CODES = {
    f.__code__ for f in (
        control.read_predicate, hungarian.solve_plain, covariance.regularize_plane_plain,
        nn_cuda.nn1_sparse_reference, nn_cuda.nn1_dense_reference,
        nn_cuda.knn_classes_reference, nn_cuda.nn1_sparse_batched_reference,
    )
}
_SYNCING_OPS = {
    "aten::nonzero", "aten::masked_select", "aten::unique_dim", "aten::_unique2",
    "aten::unique_consecutive", "aten::bincount", "aten::equal", "aten::histc",
    "aten::_local_scalar_dense", "aten::lift_fresh", "aten::repeat_interleave",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every op here is tiny and the guard runs Python around each one:
    one intra-op thread keeps the file cheap on a loaded test host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _allowed() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in _ALLOWED_CODES or f.f_code.co_filename in _ALLOWED_FILES:
            return True
        f = f.f_back
    return False


class _SyncingOps(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        bad = name in _SYNCING_OPS and not (name == "aten::repeat_interleave" and "output_size" in kwargs)
        if name in ("aten::index", "aten::index_put_", "aten::index_put"):
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] if i is not None)
        if name == "aten::segment_reduce":
            bad = not kwargs.get("unsafe", False)
        if bad and not _allowed():
            raise HostRead(f"{name} synchronizes on a CUDA device")
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_reads():
    """Raise HostRead on a host read outside the allowed CPU-only code."""
    saved = {}

    def guard(name):
        real = getattr(torch.Tensor, name)

        def guarded(self, *a, **kw):
            if not _allowed():
                raise HostRead(f"Tensor.{name} reads the device")
            return real(self, *a, **kw)

        saved[name] = real
        setattr(torch.Tensor, name, guarded)

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist"):
        guard(name)
    try:
        with _SyncingOps():
            yield
    finally:
        for name, real in saved.items():
            setattr(torch.Tensor, name, real)


def test_the_guard_catches_host_reads():
    x = torch.arange(4)
    for read in (lambda: bool(x[0] > 0), lambda: int(x[1]), lambda: x.sum().item(),
                 lambda: x.tolist(), lambda: x[x > 1], lambda: torch.nonzero(x),
                 lambda: torch.tensor([1.0, 2.0]), lambda: torch.bincount(x),
                 lambda: range(10)[x[2]], lambda: torch.equal(x, x)):
        with no_host_reads(), pytest.raises(HostRead):
            read()
    with no_host_reads():  # the predicate read of the eager driver
        assert control.read_predicate(x[1] > 0)


@pytest.mark.parametrize("arith", ["xla_host", "card"])
@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_align_lm_loops_read_only_predicates(arith, optimizer, monkeypatch):
    """The LM iteration and lambda loops (and GN's), on the host's XLA
    arithmetic and on the card's, with the accelerator's sparse NN path
    (its plain version), record_trace on."""
    src, mask, covs_s, tgt, tgt_m, covs_t = _pair(600, seed=2)
    if arith == "card":
        monkeypatch.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)
    s = gicp.GICPSettings(max_correspondence_distance=1.0, optimizer=optimizer,
                          record_trace=True, nn_impl="sparse")
    args = [t(a) for a in (src, mask, covs_s, tgt, tgt_m, covs_t)] + [torch.eye(4)]
    control.PREDICATE_READS.clear()
    with port_accelerator_paths(), no_host_reads():
        got = gicp.align(*args, s)
    with port_accelerator_paths():
        want = gicp.align(*args, s)
    for name in ("T", "converged", "iterations", "final_error", "pose_trace", "num_inliers"):
        np.testing.assert_array_equal(n(getattr(got, name)), n(getattr(want, name)), err_msg=name)
    assert int(got.iterations) > 0 and control.PREDICATE_READS["while"] > int(got.iterations)


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_card_trials_reach_the_plain_versions_only_through_the_wrappers(optimizer, monkeypatch):
    """On the card's path an LM iteration's lambda loop calls the wrapper
    ``gicp.lm_inner`` once (its kernel runs the whole loop) and GN's step
    the wrapper ``gicp.lm_propose``: the wrappers launch the kernels for
    CUDA tensors; here on CPU tensors they take the plain versions. A loop
    or step that called ``lm_*_plain`` itself would bypass the kernels on
    the card: it fails here, and so does a host read in the plain
    versions. ``lm_inner_plain`` runs its trials through
    ``lm_propose_plain`` / ``lm_decide_plain``, the split trial's plain
    versions."""
    src, mask, covs_s, tgt, tgt_m, covs_t = _pair(600, seed=3)
    monkeypatch.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)
    wrapped = collections.Counter()
    callers = {"lm_propose": (gicp.lm_propose, gicp.lm_inner_plain),
               "lm_decide": (gicp.lm_decide, gicp.lm_inner_plain), "lm_inner": (gicp.lm_inner,)}
    for name, allowed in callers.items():
        plain = getattr(gicp, f"{name}_plain")
        codes = {f.__code__: f.__name__ for f in allowed}

        def guarded(*a, _plain=plain, _codes=codes, _name=name, **k):
            caller = _codes.get(sys._getframe(1).f_code)
            if caller is None:
                raise AssertionError(f"{_name}_plain reached outside its wrapper")
            wrapped[f"{_name} from {caller}"] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(gicp, f"{name}_plain", guarded)
    s = gicp.GICPSettings(max_correspondence_distance=1.0, optimizer=optimizer, nn_impl="sparse")
    args = [t(a) for a in (src, mask, covs_s, tgt, tgt_m, covs_t)] + [torch.eye(4)]
    with port_accelerator_paths(), no_host_reads():
        res = gicp.align(*args, s)
    iterations = int(res.iterations)
    assert iterations > 0
    if optimizer == "lm":
        # one lambda loop per iteration, each one lm_inner call whose plain
        # version runs lm_max_iterations masked turns; no split trial
        assert wrapped["lm_inner from lm_inner"] == iterations
        for name in ("lm_propose", "lm_decide"):
            assert wrapped[f"{name} from lm_inner_plain"] == iterations * s.lm_max_iterations
            assert wrapped[f"{name} from {name}"] == 0
    else:
        assert wrapped["lm_propose from lm_propose"] == iterations
        assert sum(wrapped.values()) == iterations


def _ccl_inputs(seed, H=16, W=48):
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(2.0, 30.0, (H, W)).astype(np.float32)
    ranges[:, W // 3: W // 2] = 8.0  # a wall: one component across the rows
    eligible = rng.uniform(size=(H, W)) < 0.8
    return t(ranges), t(eligible)


@pytest.mark.parametrize("seed", [0, 1])
def test_ccl_sweep_reads_only_its_flag(seed):
    ranges, eligible = _ccl_inputs(seed)
    want = segmentation.label_components(ranges, eligible, 0.17, 0.2, 2.0)
    segmentation.SWEEPS.clear()
    with profiling.device_counts("cpu") as count:
        with no_host_reads():
            got = segmentation.label_components(ranges, eligible, 0.17, 0.2, 2.0)
    assert torch.equal(got.labels, want.labels)
    sweeps = count["ccl_sweeps"]
    assert sweeps >= 2 and segmentation.SWEEPS["host_reads"] == sweeps + 1
    with profiling.device_counts("cpu") as count:
        with no_host_reads():  # the sweep bound ends the loop
            segmentation.label_components(ranges, eligible, 0.17, 0.2, 2.0, max_iters=1)
    assert count["ccl_sweeps"] == 1


def _both_stores(K, P, positions, rng, counts=None):
    js, ts = jkf.empty_store(K, P), kf.empty_store(K, P, device="cpu")
    for i, pos in enumerate(positions):
        nv = int(rng.integers(0, P + 1)) if counts is None else counts[i]
        pts = np.full((P, 3), 1.0e6, np.float32)
        pts[:nv] = np.asarray(pos, np.float32) + rng.normal(0, 1, (nv, 3)).astype(np.float32)
        covs = np.broadcast_to(np.eye(3, dtype=np.float32) * (i + 1), (P, 3, 3)).copy()
        args = (np.asarray(pos, np.float32), np.array([1.0, 0, 0, 0], np.float32), pts,
                np.arange(P) < nv, covs)
        js = jkf.add_keyframe(js, jnp.bool_(True), *map(jnp.asarray, args))
        do_add, targs = torch.tensor(True), [t(a) for a in args]
        with no_host_reads():
            ts = kf.add_keyframe(ts, do_add, *targs)
        for name in kf.KeyframeStore._fields:
            np.testing.assert_array_equal(n(getattr(ts, name)), np.asarray(getattr(js, name)),
                                          err_msg=f"insert {i}: {name}")
    return js, ts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_keyframe_at_capacity_is_jax_bit_for_bit(seed):
    """Inserts past capacity (each an eviction under the nested branch),
    slot picked on the device, every field equal to JAX's after each."""
    rng = np.random.default_rng(seed)
    K, P = 6, 8
    pos = random_trajectory_positions(K + 5, seed, scale=12.0)
    _, ts = _both_stores(K, P, pos, rng)
    assert int(ts.count) == K + 5 and bool(ts.valid.all())


@pytest.mark.parametrize("max_slots,capacity", [(6, 40), (6, 23), (6, 8), (4, 64), (6, 0)])
def test_gather_submap_on_the_device_is_jax_bit_for_bit(max_slots, capacity):
    """Zero-count slots (among them the first and the last selected),
    blocks whose sentinel tails the next block overwrites, starts clamped
    at capacity; the offsets never reach the host."""
    rng = np.random.default_rng(4)
    K, P = 8, 10
    pos = random_trajectory_positions(K, 4, scale=10.0)
    js, ts = _both_stores(K, P, pos, rng, counts=[0, 7, 10, 0, 3, 10, 0, 9])
    for sel in (np.ones(K, bool), np.array([1, 0, 1, 1, 0, 1, 1, 0], bool)):
        want = jkf.gather_submap(js, jnp.asarray(sel), max_slots, capacity=capacity)
        sel_t = t(sel)
        with no_host_reads():
            got = kf.gather_submap(ts, sel_t, max_slots, capacity=capacity)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(n(g), np.asarray(w))


def test_keyframe_update_with_eviction_reads_only_predicates():
    """odometry.update_keyframes' insert branch (voxel filter, PLANE
    covariances, insert) on a full store: the nested eviction branch."""
    cfg = port_cfg(small_cfg())
    K = cfg.capacity.max_keyframes
    scans = render_seq(small_cfg(), 2)[2]
    state = pipeline.init_state(cfg, *scans[0], device="cpu")
    pos = random_trajectory_positions(K, 3, scale=20.0)
    store = state.odom.store
    for i in range(1, K):
        store = kf.add_keyframe(store, True, t(pos[i]), torch.tensor([1.0, 0, 0, 0]),
                                store.points[0], store.masks[0], store.covs[0])
    far = torch.tensor([40.0, 40.0, 0.0])
    odo = state.odom._replace(store=store, pose=far)
    assert int(store.count) == K
    want, added_w = odometry.update_keyframes(cfg, odo, *map(torch.as_tensor, scans[1]))
    control.PREDICATE_READS.clear()
    scan = [torch.as_tensor(x) for x in scans[1]]
    with port_accelerator_paths(), no_host_reads():
        got, added = odometry.update_keyframes(cfg, odo, *scan)
    assert bool(added) and bool(added_w)
    assert control.PREDICATE_READS["cond"] == 2  # the insert and, nested, the eviction
    assert int(got.store.count) == K + 1 and int(store.count) == K  # the caller's store kept
    for name in ("positions", "valid", "count"):
        np.testing.assert_array_equal(n(getattr(got.store, name)), n(getattr(want.store, name)))


def _kantplatz_scans(cfg, n):
    """tests/test_torch_kantplatz.py's scene: the camera residual grid."""
    world = synthetic.World.town(seed=11, n_static=8)
    rng = np.random.default_rng(0)
    T = np.eye(4)
    out = []
    for i in range(n):
        T[:3, 3] = [0.08 * i, 0.0, 0.0]
        out.append(synthetic.render_scan(world, T, H=cfg.detection.rows, W=cfg.detection.columns,
                                         t=0.1 * i, rng=rng))
    return out


@pytest.mark.parametrize("scene", ["doals", "kantplatz"])
def test_pipeline_step_on_accelerator_paths_reads_only_predicates(scene):
    """A whole DDLO step (detection and tracking on) on the accelerator
    branches, as the card runs it, with the card's GICP arithmetic: the
    DOALS layout, and the kantplatz camera grid with its window."""
    if scene == "doals":
        jcfg = dataclasses.replace(small_cfg(), dynamic_detection=True)
        scans = render_seq(jcfg, 3)[2]
    else:
        jcfg = small_kantplatz()
        scans = _kantplatz_scans(jcfg, 3)
    cfg = port_cfg(jcfg)
    inputs = [(*map(torch.as_tensor, scans[i]), torch.tensor(0.1 * i)) for i in (1, 2)]
    control.PREDICATE_READS.clear()
    with port_accelerator_paths(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)
        state = pipeline.init_state(cfg, *scans[0], 0.0, device="cpu")
        with no_host_reads():  # the first step rebuilds the hulls, the second reads the cache
            for pts, msk, stamp in inputs:
                state, out = pipeline.step(cfg, state, pts, msk, stamp)
    assert bool(torch.isfinite(out.odom.T).all()) and bool(out.odom.s2m_converged)
    assert control.PREDICATE_READS["cond"] >= 4 and control.PREDICATE_READS["while"] > 0
