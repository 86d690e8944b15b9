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
``knn_classes``     ``_nn_classes_kernel``      ``csrc/knn_classes.cu``
                                                ``ddlo_knn_classes``
``knn_classes_      ``_nn_classes_sparse_       ``csrc/knn_classes.cu``
sparse``            kernel``                    ``ddlo_knn_classes_sparse``
==================  ==========================  ============================

As in the JAX package, padding, transposes, AABBs and the ascending CSR
chunk lists are built in plain torch around the kernels; the wrappers
(:func:`nn1_sparse_chunks`, :func:`nn1_dense_chunks`,
:func:`knn_classes_chunks`) launch the kernel for CUDA tensors (and count
the launch) or raise; they take the plain version only for tensors that
lie on the CPU. The entry points mirror the JAX ones:
:func:`nn1_sparse` / :func:`nn1_sparse_prepared`, :func:`nn1_dense`
(``nn1_pallas``) and :func:`knn_approx` (``knn_approx_pallas``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build

# distance placed on padded / invalid slots; anything >= this loses
_BIG = 3.0e12

# kernel launches by name, counted by the wrappers where they launch
LAUNCHES: collections.Counter = collections.Counter()


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


_SOURCES = {"nn1_sparse": ("nn1_sparse.cu",), "knn_classes": ("knn_classes.cu",)}
_BUILT: Dict[str, _cuda_build.Built] = {}


def build() -> Dict[str, _cuda_build.Built]:
    """Compile (at first use; one nvcc per source, all started together)
    and load the kernel libraries: ``{"nn1_sparse": Built, "knn_classes":
    Built}``."""
    if _BUILT:
        return _BUILT
    built = _cuda_build.load_all(_SOURCES)
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib, fn, args in (
        ("nn1_sparse", "ddlo_nn1_sparse", [P] * 4 + [I] * 5 + [P] * 3),
        ("nn1_sparse", "ddlo_nn1_dense", [P] * 2 + [I] * 3 + [P] * 3),
        ("nn1_sparse", "ddlo_nn1_sparse_threads", []),
        ("knn_classes", "ddlo_knn_classes", [P] * 2 + [I] * 4 + [P] * 3),
        ("knn_classes", "ddlo_knn_classes_sparse", [P] * 4 + [I] * 6 + [P] * 3),
        ("knn_classes", "ddlo_knn_classes_queries_per_block", []),
    ):
        f = getattr(built[lib].lib, fn)
        f.argtypes = args
        f.restype = I
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


def _run(fn, name, *args):
    """Launch ``fn`` on the current stream of the args' device; raise on a
    refused launch; count it."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _launch(q, tt, counts, lists, q_tile, t_chunk):
    _check_inputs(q, tt, counts, lists)
    lib = build()["nn1_sparse"].lib
    threads = lib.ddlo_nn1_sparse_threads()
    Qp, Tp = q.shape[0], tt.shape[1]
    n_tiles, n_chunks = lists.shape
    if (
        q_tile % threads or Qp != n_tiles * q_tile or Tp != n_chunks * t_chunk
        or counts.shape[0] != n_tiles
    ):
        raise ValueError(
            f"nn1_sparse: inconsistent shapes q={tuple(q.shape)} "
            f"tt={tuple(tt.shape)} counts={tuple(counts.shape)} "
            f"lists={tuple(lists.shape)} q_tile={q_tile} t_chunk={t_chunk}"
        )
    out_idx = torch.empty(Qp, dtype=torch.int32, device=q.device)
    out_d = torch.empty(Qp, dtype=torch.float32, device=q.device)
    if Qp:
        _run(lib.ddlo_nn1_sparse, "nn1_sparse", q, tt, counts, lists,
             Qp, Tp, n_chunks, q_tile, t_chunk, out_idx, out_d)
    return out_idx, out_d


def nn1_sparse_chunks(
    q: torch.Tensor,
    tt: torch.Tensor,
    counts: torch.Tensor,
    lists: torch.Tensor,
    q_tile: int,
    t_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (idx (Qp,) int32, sqd (Qp,) f32) over padded
    query tiles. CUDA tensors launch ``csrc/nn1_sparse.cu`` (or raise);
    CPU tensors run :func:`nn1_sparse_reference`."""
    if q.is_cuda:
        return _launch(q, tt, counts, lists, q_tile, t_chunk)
    return nn1_sparse_reference(q, tt, counts, lists, q_tile, t_chunk)


def tile_chunk_lists(
    q: torch.Tensor, prep: SparseTarget, radius: float, q_tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR active-chunk lists of the padded query tiles: tile AABBs built
    from real rows only (sentinel rows >= 5e5 excluded, so an
    all-sentinel tile sweeps nothing), dilated by ``radius``, tested for
    overlap with every chunk AABB on all axes."""
    n_tiles = q.shape[0] // q_tile
    qb = q.reshape(n_tiles, q_tile, 3)
    q_real = torch.all(qb < 5.0e5, dim=-1, keepdim=True)
    q_lo = torch.where(q_real, qb, torch.inf).amin(dim=1)
    q_hi = torch.where(q_real, qb, -torch.inf).amax(dim=1)
    overlap = torch.all(
        (q_lo[:, None, :] - radius <= prep.t_hi[None, :, :])
        & (q_hi[:, None, :] + radius >= prep.t_lo[None, :, :]),
        dim=-1,
    )
    return sparse_chunk_lists(overlap)


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
    tensors launch ``ddlo_nn1_dense`` (or raise); CPU tensors run
    :func:`nn1_dense_reference`."""
    if not q.is_cuda:
        return nn1_dense_reference(q, tt)
    _check_inputs(q, tt)
    lib = build()["nn1_sparse"].lib
    Qp, Tp = q.shape[0], tt.shape[1]
    if Qp % lib.ddlo_nn1_sparse_threads() or Tp % t_chunk or Tp == 0:
        raise ValueError(
            f"nn1_dense: q rows {Qp} must be a multiple of "
            f"{lib.ddlo_nn1_sparse_threads()} and target columns {Tp} a "
            f"positive multiple of t_chunk={t_chunk}"
        )
    out_idx = torch.empty(Qp, dtype=torch.int32, device=q.device)
    out_d = torch.empty(Qp, dtype=torch.float32, device=q.device)
    if Qp:
        _run(lib.ddlo_nn1_dense, "nn1_dense", q, tt, Qp, Tp, t_chunk, out_idx, out_d)
    return out_idx, out_d


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
    :func:`knn_classes_reference`."""
    if not 1 <= k <= 128:
        raise ValueError(f"knn_classes: k={k} must be in [1, 128]")
    if not q.is_cuda:
        return knn_classes_reference(q, tt, counts, lists, q_tile, t_chunk, k)
    _check_inputs(q, tt, counts, lists)
    lib = build()["knn_classes"].lib
    qpb = lib.ddlo_knn_classes_queries_per_block()
    Qp, Tp = q.shape[0], tt.shape[1]
    sparse = counts is not None
    if (
        Qp % q_tile or q_tile % qpb or t_chunk % 128 or Tp % t_chunk or Tp == 0
        or (sparse and (lists.shape != (Qp // q_tile, Tp // t_chunk)
                        or counts.shape[0] != Qp // q_tile))
    ):
        raise ValueError(
            f"knn_classes: inconsistent shapes q={tuple(q.shape)} "
            f"tt={tuple(tt.shape)} q_tile={q_tile} (multiple of {qpb}) "
            f"t_chunk={t_chunk} (multiple of 128)"
        )
    out_idx = torch.empty((Qp, k), dtype=torch.int32, device=q.device)
    out_d = torch.empty((Qp, k), dtype=torch.float32, device=q.device)
    if Qp == 0:
        return out_idx, out_d
    if sparse:
        _run(lib.ddlo_knn_classes_sparse, "knn_classes_sparse", q, tt, counts, lists,
             Qp, Tp, Tp // t_chunk, q_tile, t_chunk, k, out_idx, out_d)
    else:
        _run(lib.ddlo_knn_classes, "knn_classes", q, tt, Qp, Tp, t_chunk, k, out_idx, out_d)
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
