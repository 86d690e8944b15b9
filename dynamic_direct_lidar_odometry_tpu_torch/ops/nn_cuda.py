"""Block-sparse 1-NN on Hopper (counterpart of ``ops/nn_pallas.py``).

The GICP correspondence search runs in every LM linearization. As in
the JAX package, the loop-invariant target side is prepared once per
registration (:func:`prepare_sparse_target`: pad to 512-row chunks with
1e6, transpose, chunk AABBs); per call the query tiles' AABBs (sentinel
rows excluded), the radius-dilated overlap test and the ascending CSR
chunk lists are built in plain torch (:func:`nn1_sparse_prepared`), and
then the hand-written CUDA kernel ``csrc/nn1_sparse.cu`` sweeps each
tile's active chunks.

:func:`nn1_sparse_chunks` is the kernel's wrapper: for a CUDA tensor it
launches the kernel (and counts the launch in :data:`LAUNCHES`) or
raises; it takes the plain version :func:`nn1_sparse_reference` only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Tuple

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


def build():
    """Compile (at first use) and load the kernel library."""
    built = _cuda_build.load("nn1_sparse", ["nn1_sparse.cu"])
    fn = built.lib.ddlo_nn1_sparse
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    built.lib.ddlo_nn1_sparse_threads.restype = ctypes.c_int
    return built


def _check(name, t, dtype, ndim):
    if not t.is_cuda or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"nn1_sparse: {name} must be a contiguous {ndim}-d CUDA {dtype} "
            f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def _launch(q, tt, counts, lists, q_tile, t_chunk):
    for name, t, dt, nd in (
        ("q", q, torch.float32, 2), ("tt", tt, torch.float32, 2),
        ("counts", counts, torch.int32, 1), ("lists", lists, torch.int32, 2),
    ):
        _check(name, t, dt, nd)
    lib = build().lib
    threads = lib.ddlo_nn1_sparse_threads()
    Qp, Tp = q.shape[0], tt.shape[1]
    n_tiles, n_chunks = lists.shape
    if (
        q.shape[1] != 3 or tt.shape[0] != 3 or q_tile % threads
        or Qp != n_tiles * q_tile or Tp != n_chunks * t_chunk
        or counts.shape[0] != n_tiles
        or len({q.device, tt.device, counts.device, lists.device}) != 1
    ):
        raise ValueError(
            f"nn1_sparse: inconsistent shapes q={tuple(q.shape)} "
            f"tt={tuple(tt.shape)} counts={tuple(counts.shape)} "
            f"lists={tuple(lists.shape)} q_tile={q_tile} t_chunk={t_chunk}"
        )
    out_idx = torch.empty(Qp, dtype=torch.int32, device=q.device)
    out_d = torch.empty(Qp, dtype=torch.float32, device=q.device)
    if Qp == 0:
        return out_idx, out_d
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ddlo_nn1_sparse(
            q.data_ptr(), tt.data_ptr(), counts.data_ptr(), lists.data_ptr(),
            Qp, Tp, n_chunks, q_tile, t_chunk,
            out_idx.data_ptr(), out_d.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nn1_sparse kernel launch failed: CUDA error {err}")
    LAUNCHES["nn1_sparse"] += 1
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
