"""Nearest-neighbor kernels on Hopper (counterpart of ``ops/nn_pallas.py``).

Every Pallas kernel of the JAX package has a hand-written CUDA kernel
here, a plain PyTorch version beside it, and a launch count in
:data:`LAUNCHES`:

==================  ==========================  ============================
kernel (LAUNCHES)   TPU kernel it replaces      CUDA source / entry point
==================  ==========================  ============================
``nn1_sparse``      ``_nn1_sparse_kernel``      ``csrc/nn1_sparse.cu``
                                                ``ddlo_nn1_sparse``
``nn1_dense``       ``_nn1_kernel``             ``csrc/nn1_sparse.cu``
                                                ``ddlo_nn1_dense``
``nn1_sparse_       ``_nn1_sparse_kernel``      ``csrc/nn1_sparse.cu``
batched``           under ``jax.vmap``          ``ddlo_nn1_sparse_batched``
``knn_classes``     ``_nn_classes_kernel``      ``csrc/knn_classes.cu``
                                                ``ddlo_knn_classes``
``knn_classes_      ``_nn_classes_sparse_       ``csrc/knn_classes.cu``
sparse``            kernel``                    ``ddlo_knn_classes_sparse``
==================  ==========================  ============================

As in the JAX package, padding, transposes, AABBs and the ascending CSR
chunk lists are built in plain torch around the kernels. The 1-NN
kernels split each query block's sweep across the card and merge the
partial (distance, index) pairs with an ``atomicMin`` of a packed 64-bit
key (:data:`KEY_INIT`, :func:`unpack_keys`); the merge is exact because a
strict-``<`` sweep over ascending indices is the lexicographic minimum
of (distance, index). The wrappers (:func:`nn1_sparse_chunks`,
:func:`nn1_dense_chunks`, :func:`knn_classes_chunks`) launch the kernel
for CUDA tensors (and count the launch) or raise; they take the plain
version only for tensors that lie on the CPU. The entry points mirror
the JAX ones:
:func:`nn1_sparse` / :func:`nn1_sparse_prepared`, :func:`nn1_dense`
(``nn1_pallas``) and :func:`knn_approx` (``knn_approx_pallas``); and
for B streams at once, :func:`prepare_sparse_targets` /
:func:`nn1_sparse_batched_prepared`.

:func:`build` builds every library of the port at once, and
:data:`LAUNCHES` counts every kernel: also the two that the JAX package
left to XLA, ``jv_solve`` (``csrc/jv_solve.cu``, launched by
``ops/hungarian.solve``), the covariances' ``window_plane_cov`` (the
window path whole: window, selection, moments, regularization, mask)
and ``regularize_plane`` (the exact path's regularization) (both
``csrc/plane_reg.cu``, ``ops/covariance.window_plane_covariances`` /
``regularize_plane``) and GICP's lambda loop,
``lm_inner`` (the whole loop) and ``lm_propose`` and ``lm_decide`` (a
split trial) (``csrc/lm_trial.cu``, ``ops/gicp.lm_inner`` /
``lm_propose`` / ``lm_decide``), ``segment_objects`` (the segment gates
and object slots, ``csrc/segment_objects.cu``, launched by
``ops/segmentation.segment_objects``) and ``set_cond``
(``csrc/graph_cond.cu``, the conditional nodes' handle write of
``core/control.py``). The counts advance where a wrapper launches, so
inside a captured graph at capture, not at replay; the same launch also
adds one to its count on the device (``utils.profiling.count``), which
a replay advances.
"""

from __future__ import annotations

import collections
import ctypes
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

# distance placed on padded / invalid slots; anything >= this loses
_BIG = 3.0e12

# kernel launches by name, counted by the wrappers where they launch
LAUNCHES: collections.Counter = collections.Counter()

# the 1-NN kernels' merge key: (bits(d) << 32) | j, min-merged; the
# initial one is (3e12, 0)
KEY_INIT = struct.unpack("<I", struct.pack("<f", _BIG))[0] << 32
# grid of the 1-NN kernels: this many waves of resident blocks if every
# query block had work (a sparse call has work in a few tiles only)
_WAVES = 8
_RESIDENT: Dict[int, int] = {}


class SparseTarget(NamedTuple):
    """Loop-invariant target-side preparation for the sparse sweep."""

    tt: torch.Tensor  # (3, Tp) padded, transposed target (contiguous)
    t_lo: torch.Tensor  # (n_chunks, 3) chunk AABB minima
    t_hi: torch.Tensor  # (n_chunks, 3) chunk AABB maxima
    n: int  # original (unpadded) target row count


def prepare_sparse_target(target: torch.Tensor, t_chunk: int = 512) -> SparseTarget:
    """Pad/transpose the target and compute its chunk AABBs. Invalid
    target rows must already sit at the far sentinel, so their chunks'
    boxes never overlap a real query tile."""
    t = pad_rows(target, t_chunk, 1.0e6)
    tb = t.reshape(-1, t_chunk, 3)
    return SparseTarget(
        tt=t.T.contiguous(), t_lo=tb.amin(dim=1), t_hi=tb.amax(dim=1),
        n=target.shape[0],
    )


def sparse_chunk_lists(overlap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_tiles, n_chunks) bool overlap -> per-tile ASCENDING active
    chunk ids padded with n_chunks (never read: the kernel loops
    ``j < count``) and the counts, both int32. Ascending order keeps the
    sequential-sweep tie rule (lowest target index wins)."""
    n_chunks = overlap.shape[1]
    ids = torch.arange(n_chunks, dtype=torch.int32, device=overlap.device)
    lst = torch.where(overlap, ids, n_chunks).to(torch.int32)
    lst = torch.sort(lst, dim=1).values
    counts = overlap.sum(dim=1, dtype=torch.int32)
    return counts, lst


def nn1_sparse_reference(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: torch.Tensor,
    lists: torch.Tensor,
    q_tile: int,
    t_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same contract: for each query
    tile, the active chunks are concatenated in ascending order, the
    distances taken as ``dx*dx + dy*dy + dz*dz``, and ``argmin`` (first
    minimum, so the lowest target index) picks the winner; a query with
    nothing below 3e12 gets (3e12, 0)."""
    Qp = q.shape[0]
    idx = torch.zeros(Qp, dtype=torch.int32, device=q.device)
    dist = torch.full((Qp,), _BIG, dtype=torch.float32, device=q.device)
    ar = torch.arange(t_chunk, device=q.device)
    for i, c in enumerate(counts.tolist()):
        if c == 0:
            continue
        cols = (lists[i, :c, None].long() * t_chunk + ar).reshape(-1)
        t = tt[:, cols]
        qt = q[i * q_tile : (i + 1) * q_tile]
        dx = qt[:, 0:1] - t[0]
        dy = qt[:, 1:2] - t[1]
        dz = qt[:, 2:3] - t[2]
        d = dx * dx + dy * dy + dz * dz
        am = torch.argmin(d, dim=1)
        dm = torch.gather(d, 1, am[:, None])[:, 0]
        take = dm < _BIG
        dist[i * q_tile : (i + 1) * q_tile] = torch.where(take, dm, _BIG)
        idx[i * q_tile : (i + 1) * q_tile] = torch.where(
            take, cols[am], 0
        ).to(torch.int32)
    return idx, dist


# every library of the port's CUDA sources: this module's, and those of
# ``ops/hungarian.py`` (``jv_solve``), ``ops/covariance.py``
# (``plane_reg``), ``core/control.py`` (``graph_cond``),
# ``ops/gicp.py`` (``lm_trial``), ``utils/profiling.py`` (``trace``) and
# ``ops/segmentation.py`` (``segment_objects``), built together at first use
_SOURCES = {"nn1_sparse": ("nn1_sparse.cu",), "knn_classes": ("knn_classes.cu",),
            "jv_solve": ("jv_solve.cu",), "plane_reg": ("plane_reg.cu",),
            "graph_cond": ("graph_cond.cu",), "lm_trial": ("lm_trial.cu",),
            "trace": ("trace.cu",), "segment_objects": ("segment_objects.cu",)}
_BUILT: Dict[str, _cuda_build.Built] = {}


def build() -> Dict[str, _cuda_build.Built]:
    """Compile (at first use; one nvcc per source, all started together)
    and load the kernel libraries: ``{name: Built}`` for each name of
    :data:`_SOURCES`."""
    if _BUILT:
        return _BUILT
    built = _cuda_build.load_all(_SOURCES)
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib, fn, args in (
        ("nn1_sparse", "ddlo_nn1_sparse", [P] * 4 + [I] * 6 + [P] * 2),
        ("nn1_sparse", "ddlo_nn1_dense", [P] * 2 + [I] * 3 + [P] * 2),
        ("nn1_sparse", "ddlo_nn1_sparse_batched", [P] * 4 + [I] * 8 + [P] * 2),
        ("nn1_sparse", "ddlo_nn1_rows_per_block", []),
        ("nn1_sparse", "ddlo_nn1_stage_rows", []),
        ("nn1_sparse", "ddlo_nn1_resident_blocks", []),
        ("knn_classes", "ddlo_knn_classes", [P] * 2 + [I] * 4 + [P] * 3),
        ("knn_classes", "ddlo_knn_classes_sparse", [P] * 4 + [I] * 6 + [P] * 3),
        ("knn_classes", "ddlo_knn_classes_queries_per_block", []),
        ("knn_classes", "ddlo_knn_classes_unit_rows", []),
        ("jv_solve", "ddlo_jv_solve", [P, P, I, P, P]),
        ("jv_solve", "ddlo_jv_shared_max_n", []),
        ("plane_reg", "ddlo_plane_reg", [P, I, P, P]),
        ("plane_reg", "ddlo_window_plane_cov", [P, P, I, I, P, P]),
        ("graph_cond", "ddlo_set_cond", [P] * 3 + [I] * 4 + [P, I] + [ctypes.c_ulonglong] * 2 + [I] + [P] * 3),
        ("graph_cond", "ddlo_set_cond_blocks", [I, I]),
        ("graph_cond", "ddlo_cond_handle", [P, P]),
        ("graph_cond", "ddlo_cond_node", [P, I, ctypes.c_ulonglong, P]),
        ("graph_cond", "ddlo_capture_into", [P, P]),
        ("graph_cond", "ddlo_capture_close", [P]),
        ("graph_cond", "ddlo_stream_create", [P]),
        ("lm_trial", "ddlo_lm_propose", [P] * 4 + [I] + [P] * 3),
        ("lm_trial", "ddlo_lm_decide", [P] * 15 + [I, ctypes.c_float, ctypes.c_float, P]),
        ("lm_trial", "ddlo_lm_inner", [P] * 8 + [ctypes.c_longlong, I] + [P] * 10 + [I] * 3
         + [ctypes.c_float] * 2 + [P]),
        ("lm_trial", "ddlo_lm_inner_shared_max_n", []),
        ("lm_trial", "ddlo_lm_inner_layout", []),
        ("trace", "ddlo_span", [P] * 3 + [I] * 4 + [P]),
        ("segment_objects", "ddlo_segment_objects", [P] * 5 + [I] * 8 + [ctypes.c_float] * 4 + [P] * 7),
        ("segment_objects", "ddlo_segment_objects_max_candidates", []),
        ("segment_objects", "ddlo_segment_objects_lanes", []),
    ):
        f = getattr(built[lib].lib, fn)
        f.argtypes = args
        f.restype = I
    f = built["segment_objects"].lib.ddlo_segment_objects_work_words
    f.argtypes, f.restype = [I, I], ctypes.c_longlong
    _BUILT.update(built)
    return _BUILT


def _check(name, t, dtype, ndim):
    if not t.is_cuda or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"nn_cuda: {name} must be a contiguous {ndim}-d CUDA {dtype} "
            f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def _check_inputs(q, tt, counts=None, lists=None):
    checks = [("q", q, torch.float32, 2), ("tt", tt, torch.float32, 2)]
    if counts is not None:
        checks += [("counts", counts, torch.int32, 1), ("lists", lists, torch.int32, 2)]
    for name, t, dt, nd in checks:
        _check(name, t, dt, nd)
    tensors = [q, tt] + ([counts, lists] if counts is not None else [])
    if q.shape[1] != 3 or tt.shape[0] != 3 or len({x.device for x in tensors}) != 1:
        raise ValueError(
            f"nn_cuda: expected q (Q, 3) and tt (3, T) on one device, got "
            f"q={tuple(q.shape)} tt={tuple(tt.shape)}"
        )


def run_kernel(fn, name, *args):
    """Launch ``fn`` on the current stream of the first tensor arg's
    device; raise on a refused launch; count it under ``name`` in
    :data:`LAUNCHES` (on the host) and on the device
    (``utils.profiling.count``, after the launch on the same stream: a
    graph replay counts it too). Tensors pass as their data pointers,
    None as a null pointer."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        profiling.count(device, name)
    LAUNCHES[name] += 1


def _resident_blocks(lib, device: torch.device) -> int:
    """Blocks of the 1-NN kernel resident on ``device`` at once (a host
    query of the CUDA runtime, cached per device: no device read)."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _RESIDENT:
        with torch.cuda.device(key):
            n = lib.ddlo_nn1_resident_blocks()
        if n <= 0:
            raise RuntimeError(f"nn1: occupancy query failed on cuda:{key}")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def nn1_splits(units: int, query_blocks: int, resident: int) -> int:
    """Splits of each query block's work (grid y) from static shapes only:
    enough blocks for about ``_WAVES`` waves of ``resident`` blocks, at
    most one split per ``units`` (target rows / stage rows) and the
    grid's y limit. The kernel cuts each tile's own work (from the device
    counts) into this many runs."""
    want = -(-_WAVES * resident // max(query_blocks, 1))
    return max(1, min(units, want, 65535))


def unpack_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Qp,) int64 packed keys ``(bits(d) << 32) | j`` -> (idx int32, sqd
    f32), the two 32-bit halves of each key as views (little-endian: the
    index is the low word); no copy, no launch."""
    halves = keys.view(torch.int32).view(-1, 2)
    return halves[:, 0], halves[:, 1].view(torch.float32)


def _nn1_launch(lib, fn, name, q, tt, units, args):
    """One 1-NN call on the card: the merge keys filled with
    :data:`KEY_INIT` (one fill, counted as ``nn1_key_fill``), the kernel
    over (query blocks) x :func:`nn1_splits` blocks, the result as the
    keys' halves. ``units``: a full list's target rows over the stage
    rows (the most work one query block can have)."""
    if tt.data_ptr() % 16:
        raise ValueError("nn1: tt must be 16-byte aligned (cp.async staging)")
    Qp = q.shape[0]
    keys = torch.empty(0, dtype=torch.int64, device=q.device)
    if Qp:
        blocks = -(-Qp // lib.ddlo_nn1_rows_per_block())
        splits = nn1_splits(units, blocks, _resident_blocks(lib, q.device))
        keys = torch.full((Qp,), KEY_INIT, dtype=torch.int64, device=q.device)
        LAUNCHES["nn1_key_fill"] += 1
        run_kernel(fn, name, *args, splits, keys)
    return unpack_keys(keys)


def _launch(q, tt, counts, lists, q_tile, t_chunk):
    _check_inputs(q, tt, counts, lists)
    lib = build()["nn1_sparse"].lib
    rows, stage = lib.ddlo_nn1_rows_per_block(), lib.ddlo_nn1_stage_rows()
    Qp, Tp = q.shape[0], tt.shape[1]
    n_tiles, n_chunks = lists.shape
    if (
        q_tile % rows or t_chunk % stage or Qp != n_tiles * q_tile
        or Tp != n_chunks * t_chunk or counts.shape[0] != n_tiles
    ):
        raise ValueError(
            f"nn1_sparse: inconsistent shapes q={tuple(q.shape)} "
            f"tt={tuple(tt.shape)} counts={tuple(counts.shape)} "
            f"lists={tuple(lists.shape)} q_tile={q_tile} (multiple of {rows}) "
            f"t_chunk={t_chunk} (multiple of {stage})"
        )
    return _nn1_launch(lib, lib.ddlo_nn1_sparse, "nn1_sparse", q, tt,
                       n_chunks * (t_chunk // stage),
                       (q, tt, counts, lists, Qp, Tp, n_chunks, q_tile, t_chunk))


def nn1_sparse_chunks(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: torch.Tensor,
    lists: torch.Tensor,
    q_tile: int,
    t_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (idx (Qp,) int32, sqd (Qp,) f32) over padded
    query tiles. CUDA tensors launch ``csrc/nn1_sparse.cu`` (or raise):
    one key fill and one kernel launch, no host read, and the outputs are
    the halves of the merge keys (:func:`unpack_keys`). CPU tensors run
    :func:`nn1_sparse_reference`."""
    if q.is_cuda:
        return _launch(q, tt, counts, lists, q_tile, t_chunk)
    return nn1_sparse_reference(q, tt, counts, lists, q_tile, t_chunk)


def _tile_overlap(q, t_lo, t_hi, radius: float, q_tile: int) -> torch.Tensor:
    """(..., n_tiles, n_chunks) bool: the padded query tiles' AABBs, from
    real rows only (sentinel rows >= 5e5 excluded, so an all-sentinel
    tile sweeps nothing), dilated by ``radius``, against every chunk AABB
    on all axes. ``q`` (..., Qp, 3), ``t_lo``/``t_hi`` (..., n_chunks, 3)."""
    qb = q.unflatten(-2, (-1, q_tile))
    q_real = torch.all(qb < 5.0e5, dim=-1, keepdim=True)
    q_lo = torch.where(q_real, qb, torch.inf).amin(dim=-2)
    q_hi = torch.where(q_real, qb, -torch.inf).amax(dim=-2)
    return torch.all(
        (q_lo[..., :, None, :] - radius <= t_hi[..., None, :, :])
        & (q_hi[..., :, None, :] + radius >= t_lo[..., None, :, :]),
        dim=-1,
    )


def tile_chunk_lists(
    q: torch.Tensor, prep: SparseTarget, radius: float, q_tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR active-chunk lists of the padded query tiles (see
    :func:`_tile_overlap`)."""
    return sparse_chunk_lists(_tile_overlap(q, prep.t_lo, prep.t_hi, radius, q_tile))


def nn1_sparse_prepared(
    query: torch.Tensor,
    prep: SparseTarget,
    radius: float,
    q_tile: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse 1-NN against a :func:`prepare_sparse_target` result: exact
    for every query whose true nearest target lies within ``radius``;
    others report a distance >= 3e12 or a farther in-tile candidate."""
    Q = query.shape[0]
    t_chunk = prep.tt.shape[1] // prep.t_lo.shape[0]
    q = pad_rows(query, q_tile, 1.0e6).contiguous()
    counts, lst = tile_chunk_lists(q, prep, radius, q_tile)
    idx, sqd = nn1_sparse_chunks(q, prep.tt, counts, lst, q_tile, t_chunk)
    return torch.clamp_max(idx[:Q], prep.n - 1), sqd[:Q]


def nn1_sparse(
    query: torch.Tensor,
    target: torch.Tensor,
    radius: float,
    q_tile: int = 1024,
    t_chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-call radius-pruned 1-NN (counterpart of ``nn1_sparse_pallas``)."""
    return nn1_sparse_prepared(
        query, prepare_sparse_target(target, t_chunk), radius, q_tile
    )


class BatchedSparseTarget(NamedTuple):
    """:class:`SparseTarget` of B streams, the padded targets stacked along
    the columns of ``tt``."""

    tt: torch.Tensor  # (3, B * Tp) stream b in columns [b * Tp, (b + 1) * Tp)
    t_lo: torch.Tensor  # (B, n_chunks, 3)
    t_hi: torch.Tensor  # (B, n_chunks, 3)
    n: int  # target rows of one stream (unpadded)


def _pad_dim1(x: torch.Tensor, m: int, fill: float) -> torch.Tensor:
    return pad_rows(x.transpose(0, 1), m, fill).transpose(0, 1)


def prepare_sparse_targets(targets: torch.Tensor, t_chunk: int = 512) -> BatchedSparseTarget:
    """:func:`prepare_sparse_target` of each of B targets (B, M, 3), stacked."""
    t = _pad_dim1(targets, t_chunk, 1.0e6)
    tb = t.unflatten(1, (-1, t_chunk))
    return BatchedSparseTarget(
        tt=t.reshape(-1, 3).T.contiguous(), t_lo=tb.amin(dim=2), t_hi=tb.amax(dim=2),
        n=targets.shape[1],
    )


def nn1_sparse_batched_reference(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: torch.Tensor,
    lists: torch.Tensor,
    q_tile: int,
    t_chunk: int,
    tiles_per_stream: int,
    t_stream: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched entry, same contract: the
    stacked problem swept as :func:`nn1_sparse_reference` sweeps one
    (the lists hold stacked chunk ids), then each found index taken back
    to its stream's own target rows (a query with nothing below 3e12
    keeps (3e12, 0))."""
    idx, dist = nn1_sparse_reference(q, tt, counts, lists, q_tile, t_chunk)
    stream = torch.arange(q.shape[0], device=q.device) // (tiles_per_stream * q_tile)
    return torch.where(dist < _BIG, idx - stream * t_stream, idx).to(torch.int32), dist


def nn1_sparse_batched_chunks(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: torch.Tensor,
    lists: torch.Tensor,
    q_tile: int,
    t_chunk: int,
    tiles_per_stream: int,
    t_stream: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched entry's wrapper: B stacked sparse problems, ``q``
    (B * tiles_per_stream * q_tile, 3), ``tt`` (3, B * t_stream), per
    stacked tile ``counts`` and ``lists`` (ascending stacked chunk ids,
    row stride one stream's chunk count). Returns (idx, sqd) per stacked
    row, the index local to the row's stream. CUDA tensors launch
    ``ddlo_nn1_sparse_batched`` once for the whole batch (a key fill and
    the kernel; or raise); CPU tensors run
    :func:`nn1_sparse_batched_reference`."""
    if not q.is_cuda:
        return nn1_sparse_batched_reference(
            q, tt, counts, lists, q_tile, t_chunk, tiles_per_stream, t_stream
        )
    _check_inputs(q, tt, counts, lists)
    lib = build()["nn1_sparse"].lib
    rows, stage = lib.ddlo_nn1_rows_per_block(), lib.ddlo_nn1_stage_rows()
    Qp, Tp = q.shape[0], tt.shape[1]
    n_tiles, n_chunks = lists.shape
    if (
        q_tile % rows or t_chunk % stage or Qp != n_tiles * q_tile
        or counts.shape[0] != n_tiles or n_tiles % tiles_per_stream
        or t_stream != n_chunks * t_chunk
        or Tp != (n_tiles // tiles_per_stream) * t_stream
    ):
        raise ValueError(
            f"nn1_sparse_batched: inconsistent shapes q={tuple(q.shape)} "
            f"tt={tuple(tt.shape)} counts={tuple(counts.shape)} "
            f"lists={tuple(lists.shape)} q_tile={q_tile} t_chunk={t_chunk} "
            f"tiles_per_stream={tiles_per_stream} t_stream={t_stream}"
        )
    if Tp >= 2**31:  # the key's index half, and the kernel's int columns
        raise ValueError(f"nn1_sparse_batched: {Tp} stacked target rows exceed 2^31 - 1")
    # units: one stream's full list (a tile never sweeps another stream's)
    return _nn1_launch(lib, lib.ddlo_nn1_sparse_batched, "nn1_sparse_batched", q, tt,
                       n_chunks * (t_chunk // stage),
                       (q, tt, counts, lists, Qp, Tp, n_chunks, q_tile, t_chunk,
                        tiles_per_stream, t_stream))


def nn1_sparse_batched_prepared(
    query: torch.Tensor,
    prep: BatchedSparseTarget,
    radius: float,
    q_tile: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn1_sparse_prepared` of B streams in one kernel launch:
    ``query`` (B, Q, 3) against :func:`prepare_sparse_targets`. Each
    stream's rows equal its own :func:`nn1_sparse_prepared` call, bit for
    bit. Returns (idx (B, Q) int32, sqd (B, Q) f32)."""
    Bn, Q = query.shape[:2]
    n_chunks = prep.t_lo.shape[1]
    t_stream = prep.tt.shape[1] // Bn
    t_chunk = t_stream // n_chunks
    q = _pad_dim1(query, q_tile, 1.0e6)
    n_tiles = q.shape[1] // q_tile
    counts, lst = sparse_chunk_lists(
        _tile_overlap(q, prep.t_lo, prep.t_hi, radius, q_tile).flatten(0, 1)
    )
    first = torch.arange(Bn, dtype=torch.int32, device=q.device) * n_chunks
    lst = lst + first.repeat_interleave(n_tiles)[:, None]
    idx, sqd = nn1_sparse_batched_chunks(
        q.reshape(-1, 3).contiguous(), prep.tt, counts, lst, q_tile, t_chunk, n_tiles, t_stream
    )
    return (torch.clamp_max(idx.view(Bn, -1)[:, :Q], prep.n - 1),
            sqd.view(Bn, -1)[:, :Q])


def nn1_dense_reference(
    q: torch.Tensor, tt: torch.Tensor, q_tile: int = 1024, t_block: int = 8192
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dense kernel, same contract: every
    target column swept, distances as ``dx*dx + dy*dy + dz*dz``, running
    best from (3e12, 0) kept by strict ``<`` over ascending target blocks
    of the ``argmin`` (first minimum) of each block. Works on query tiles
    and target blocks so no (Q, T) distance matrix is ever formed."""
    Qp, Tp = q.shape[0], tt.shape[1]
    idx = torch.zeros(Qp, dtype=torch.int32, device=q.device)
    dist = torch.full((Qp,), _BIG, dtype=torch.float32, device=q.device)
    for q0 in range(0, Qp, q_tile):
        qt = q[q0 : q0 + q_tile]
        bd, bi = dist[q0 : q0 + q_tile], idx[q0 : q0 + q_tile]
        for t0 in range(0, Tp, t_block):
            t = tt[:, t0 : t0 + t_block]
            dx = qt[:, 0:1] - t[0]
            dy = qt[:, 1:2] - t[1]
            dz = qt[:, 2:3] - t[2]
            d = dx * dx + dy * dy + dz * dz
            am = torch.argmin(d, dim=1)
            dm = torch.gather(d, 1, am[:, None])[:, 0]
            take = dm < bd
            bd.copy_(torch.where(take, dm, bd))
            bi.copy_(torch.where(take, am + t0, bi))
    return idx, dist


def nn1_dense_chunks(
    q: torch.Tensor, tt: torch.Tensor, t_chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense kernel's wrapper: (idx (Qp,) int32, sqd (Qp,) f32) of
    every padded query row against the whole padded (3, Tp) target. CUDA
    tensors launch ``ddlo_nn1_dense`` (or raise), as the sparse wrapper
    does: a key fill and the kernel; CPU tensors run
    :func:`nn1_dense_reference`."""
    if not q.is_cuda:
        return nn1_dense_reference(q, tt)
    _check_inputs(q, tt)
    lib = build()["nn1_sparse"].lib
    stage = lib.ddlo_nn1_stage_rows()
    Qp, Tp = q.shape[0], tt.shape[1]
    if Tp % t_chunk or t_chunk % stage or Tp == 0:
        raise ValueError(
            f"nn1_dense: target columns {Tp} must be a positive multiple of "
            f"t_chunk={t_chunk}, itself a multiple of {stage}"
        )
    return _nn1_launch(lib, lib.ddlo_nn1_dense, "nn1_dense", q, tt, Tp // stage, (q, tt, Qp, Tp))


def nn1_dense(
    query: torch.Tensor,
    target: torch.Tensor,
    q_tile: int = 1024,
    t_chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force 1-NN (counterpart of ``nn1_pallas``): queries
    padded with 0.0, the target with 1e6 into ``t_chunk`` rows; the index
    clamped to the unpadded target. Invalid rows must sit at the far
    sentinel on both sides."""
    Q, Tn = query.shape[0], target.shape[0]
    q = pad_rows(query, q_tile, 0.0).contiguous()
    tt = pad_rows(target, t_chunk, 1.0e6).T.contiguous()
    idx, sqd = nn1_dense_chunks(q, tt, t_chunk)
    return torch.clamp_max(idx[:Q], Tn - 1), sqd[:Q]


def knn_classes_reference(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: Optional[torch.Tensor],
    lists: Optional[torch.Tensor],
    q_tile: int,
    t_chunk: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the lane-class kernels, same contract: per
    query tile, its chunks (every chunk when ``counts`` is None, else the
    tile's ascending list) concatenated and differenced into (QT, n/128,
    128) distances; per class (index mod 128) the first minimum over axis
    1, a class with nothing below 3e12 keeping (3e12, 0); then a stable
    ascending sort of the 128 class minima (equal distances: lower class
    first) and the first ``k``. Returns (idx, sqd), each (Qp, k)."""
    Qp, Tp = q.shape[0], tt.shape[1]
    dev = q.device
    out_i = torch.zeros((Qp, k), dtype=torch.int32, device=dev)
    out_d = torch.zeros((Qp, k), dtype=torch.float32, device=dev)
    ar = torch.arange(t_chunk, device=dev)
    lanes = torch.arange(128, device=dev)
    n_tiles = Qp // q_tile
    tile_counts = [Tp // t_chunk] * n_tiles if counts is None else counts.tolist()
    for i, c in enumerate(tile_counts):
        if counts is None:
            cols = torch.arange(Tp, device=dev)
        else:
            cols = (lists[i, :c, None].long() * t_chunk + ar).reshape(-1)
        qt = q[i * q_tile : (i + 1) * q_tile]
        if cols.numel() == 0:
            cd = torch.full((q_tile, 128), _BIG, device=dev)
            ci = torch.zeros((q_tile, 128), dtype=torch.long, device=dev)
        else:
            t = tt[:, cols]
            dx = qt[:, 0:1] - t[0]
            dy = qt[:, 1:2] - t[1]
            dz = qt[:, 2:3] - t[2]
            d = (dx * dx + dy * dy + dz * dz).reshape(q_tile, -1, 128)
            am = torch.argmin(d, dim=1)  # (QT, 128) first minimum per class
            cd = torch.gather(d, 1, am[:, None, :])[:, 0]
            ci = cols.reshape(-1, 128)[am, lanes]
            take = cd < _BIG
            cd = torch.where(take, cd, _BIG)
            ci = torch.where(take, ci, 0)
        sd, pos = torch.sort(cd, dim=1, stable=True)
        out_d[i * q_tile : (i + 1) * q_tile] = sd[:, :k]
        out_i[i * q_tile : (i + 1) * q_tile] = torch.gather(ci, 1, pos[:, :k]).to(torch.int32)
    return out_i, out_d


def knn_classes_chunks(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: Optional[torch.Tensor],
    lists: Optional[torch.Tensor],
    q_tile: int,
    t_chunk: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lane-class kernels' wrapper: (idx, sqd), each (Qp, k), before
    the index clamp. ``counts``/``lists`` None selects the dense kernel
    (``knn_classes``), else the pruned one (``knn_classes_sparse``). CUDA
    tensors launch it (or raise); CPU tensors run
    :func:`knn_classes_reference`. One device operation per call: the
    kernel writes every output element, so nothing is filled first."""
    if not 1 <= k <= 128:
        raise ValueError(f"knn_classes: k={k} must be in [1, 128]")
    if not q.is_cuda:
        return knn_classes_reference(q, tt, counts, lists, q_tile, t_chunk, k)
    _check_inputs(q, tt, counts, lists)
    lib = build()["knn_classes"].lib
    qpb, unit = lib.ddlo_knn_classes_queries_per_block(), lib.ddlo_knn_classes_unit_rows()
    Qp, Tp = q.shape[0], tt.shape[1]
    sparse = counts is not None
    if tt.data_ptr() % 16:
        raise ValueError("knn_classes: tt must be 16-byte aligned (cp.async staging)")
    if (
        Qp % q_tile or q_tile % qpb or t_chunk % unit or Tp % t_chunk or Tp == 0
        or (sparse and (lists.shape != (Qp // q_tile, Tp // t_chunk)
                        or counts.shape[0] != Qp // q_tile))
    ):
        raise ValueError(
            f"knn_classes: inconsistent shapes q={tuple(q.shape)} "
            f"tt={tuple(tt.shape)} q_tile={q_tile} (multiple of {qpb}) "
            f"t_chunk={t_chunk} (multiple of {unit})"
        )
    out_idx = torch.empty((Qp, k), dtype=torch.int32, device=q.device)
    out_d = torch.empty((Qp, k), dtype=torch.float32, device=q.device)
    if Qp == 0:
        return out_idx, out_d
    if sparse:
        run_kernel(lib.ddlo_knn_classes_sparse, "knn_classes_sparse", q, tt, counts, lists,
             Qp, Tp, Tp // t_chunk, q_tile, t_chunk, k, out_idx, out_d)
    else:
        run_kernel(lib.ddlo_knn_classes, "knn_classes", q, tt, Qp, Tp, t_chunk, k, out_idx, out_d)
    return out_idx, out_d


def class_chunk_lists(
    q: torch.Tensor, t: torch.Tensor, radius: float, q_tile: int, t_chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR chunk lists of ``knn_approx(prune_radius=...)``: tile boxes from
    EVERY padded query row (the 0.0 padding and sentinel rows included,
    as ``knn_approx_pallas`` builds them), chunk boxes from the padded
    target, overlap dilated by ``radius`` on all axes."""
    qb = q.reshape(-1, q_tile, 3)
    tb = t.reshape(-1, t_chunk, 3)
    overlap = torch.all(
        (qb.amin(dim=1)[:, None, :] - radius <= tb.amax(dim=1)[None])
        & (qb.amax(dim=1)[:, None, :] + radius >= tb.amin(dim=1)[None]),
        dim=-1,
    )
    return sparse_chunk_lists(overlap)


def knn_approx(
    query: torch.Tensor,
    target: torch.Tensor,
    k: int,
    q_tile: int = 1024,
    t_chunk: int = 512,
    prune_radius: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-NN (counterpart of ``knn_approx_pallas``): per query,
    the k smallest of its 128 lane-class minima (class = target index mod
    128), ascending, the index clamped to the unpadded target. Queries
    padded with 0.0, the target with 1e6. ``prune_radius`` sweeps only the
    chunks whose box lies within it of the query tile's box. Returns
    (idx (Q, k) int32, sqdist (Q, k) f32)."""
    if k > 128:
        raise ValueError("knn_approx supports k <= 128")
    Q, Tn = query.shape[0], target.shape[0]
    q = pad_rows(query, q_tile, 0.0).contiguous()
    t = pad_rows(target, t_chunk, 1.0e6)
    counts = lists = None
    if prune_radius is not None:
        counts, lists = class_chunk_lists(q, t, prune_radius, q_tile, t_chunk)
    idx, sqd = knn_classes_chunks(q, t.T.contiguous(), counts, lists, q_tile, t_chunk, k)
    return torch.clamp_max(idx[:Q], Tn - 1), sqd[:Q]
