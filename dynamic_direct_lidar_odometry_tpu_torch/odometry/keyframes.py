"""Fixed-capacity keyframe store and locality-based submap selection
(counterpart of ``odometry/keyframes.py``).

The submap is the union of the top-knn keyframes nearest the current
pose and the top-kcv / top-kcc nearest among the convex / concave hull
keyframes, "top-k" keeping every frame that ties the k-th distance. The
hulls are the JAX package's exact on-device forms: up to 64 keyframes
the DENSE (K, K, K) shapes (brute-force facet test; alpha-complex test
with inCircle determinants), above that the BLOCKED sweeps over the
triple list (normalized facet planes; circumcenter emptiness), both
with the alpha-exposure boundary-edge test. :func:`exact_hull_masks` is
the host (scipy) oracle and the ``hulls="exact"`` replay mode.

:func:`add_keyframe` returns a new store and leaves the caller's intact,
as the JAX package does: the replay keeps the state of the scan before
for its one-scan-late bookkeeping, checkpoints and NaN rollback. The
slot, the eviction at capacity and the submap's block offsets are picked
on the device (no host read; ``core/control.cond`` for the eviction).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL

_INF = 3.0e12
# elements of one (triples, K) temporary of the blocked sweeps (64 MB in
# f32): 3 blocks at K = 128, 43 at K = 256; a block is ~30 device ops
_BLOCK_ELEMS = 1 << 24
# calls of the blocked (K > 64) hull sweeps, by hull; read by chip_smoke.py
BLOCKED_CALLS = {"convex": 0, "concave": 0}


class KeyframeStore(NamedTuple):
    positions: torch.Tensor  # (K, 3)
    quats: torch.Tensor  # (K, 4) [w,x,y,z]
    points: torch.Tensor  # (K, P, 3)
    masks: torch.Tensor  # (K, P) bool
    covs: torch.Tensor  # (K, P, 3, 3)
    valid: torch.Tensor  # (K,) bool
    count: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]


def empty_store(max_keyframes: int, max_points: int, *, device="cuda") -> KeyframeStore:
    K, P = max_keyframes, max_points
    f32 = torch.float32
    device = device_mod.resolve(device)
    return KeyframeStore(
        positions=torch.zeros((K, 3), dtype=f32, device=device),
        quats=torch.tensor([1.0, 0, 0, 0], dtype=f32, device=device).repeat(K, 1),
        points=torch.full((K, P, 3), SENTINEL, dtype=f32, device=device),
        masks=torch.zeros((K, P), dtype=torch.bool, device=device),
        covs=torch.eye(3, dtype=f32, device=device).repeat(K, P, 1, 1),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def clone_store(store: KeyframeStore) -> KeyframeStore:
    """A copy of every field (the carry that :func:`insert_keyframe_`
    writes)."""
    return KeyframeStore(*(t.clone() for t in store))


def insert_keyframe_(
    store: KeyframeStore,
    position: torch.Tensor,
    quat: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    covs: torch.Tensor,
) -> None:
    """Insert a keyframe into ``store`` IN PLACE, its slot picked on the
    device: slot ``count``, or at capacity the farthest-from-``position``
    keyframe that is not a convex-hull vertex (the farthest overall if
    every valid keyframe is one). The hull runs only at capacity, under a
    ``core/control.cond`` (the JAX package's ``lax.cond``)."""
    K = store.capacity
    slot = torch.clamp_max(store.count, K - 1).to(torch.int64).reshape(1)

    def victim(slot):
        ds = torch.linalg.vector_norm(store.positions - position, dim=1)
        hull = convex_hull_mask(store.positions, store.valid)
        cand = store.valid & ~hull
        cand = torch.where(torch.any(cand), cand, store.valid)
        slot.copy_(torch.argmax(torch.where(cand, ds, -1.0)).reshape(1))

    control.cond(store.count >= K, victim, None, (slot,))
    for t, row in zip(store[:5], (position, quat, points, mask, covs)):
        t.index_copy_(0, slot, row.to(t.dtype)[None])
    store.valid.index_fill_(0, slot, True)
    store.count.add_(1)


def add_keyframe(
    store: KeyframeStore,
    do_add,
    position: torch.Tensor,
    quat: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    covs: torch.Tensor,
) -> KeyframeStore:
    """Insert a keyframe when ``do_add`` (a bool or a 0-d bool tensor,
    decided by ``core/control.cond``), as :func:`insert_keyframe_` does,
    into a copy of ``store``; the caller's store is left as it was."""
    def insert(*fields):
        insert_keyframe_(KeyframeStore(*fields), position, quat, points, mask, covs)

    new = clone_store(store)
    pred = torch.as_tensor(do_add, dtype=torch.bool, device=store.count.device)
    control.cond(pred, insert, None, tuple(new))
    return new


def overflow_count(store: KeyframeStore) -> torch.Tensor:
    """How many keyframes were accepted past capacity (each evicted the
    farthest non-hull keyframe, see :func:`add_keyframe`): the replay's
    saturation warning."""
    return torch.clamp_min(store.count - store.capacity, 0)


# ---------------------------------------------------------------------------
# Hull membership, exact and on-device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _index_tuples(K: int, r: int, device: torch.device) -> torch.Tensor:
    """All i < j (< k) of range(K), (r, n) int64 on ``device``."""
    return torch.combinations(torch.arange(K), r=r).T.contiguous().to(device)


def _blocks(K: int, r: int, device: torch.device):
    """The index tuples in blocks of at most ``_BLOCK_ELEMS // K``: the
    masks are ORs over tuples, so any block size gives the same bits."""
    return torch.split(_index_tuples(K, r, device), max(1, _BLOCK_ELEMS // K), dim=1)


def _mark(mask: torch.Tensor, hit: torch.Tensor, *idx: torch.Tensor) -> None:
    """mask[i] = True for every endpoint i of a hit tuple, with no host
    sync: misses write the scratch slot ``mask[K]``. Every write is True,
    so repeated indices give the same bits on any device."""
    K = mask.shape[0] - 1
    for i in idx:
        mask.index_put_((torch.where(hit, i, K),), torch.ones_like(hit))


def _dot3(n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """sum_d n[..., d] * p[d] with explicit f32 muls/adds (no matmul
    kernel, so the same rounding on CPU and CUDA)."""
    return n[..., 0] * p[..., 0] + n[..., 1] * p[..., 1] + n[..., 2] * p[..., 2]


def _cross3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u x v over the last axis with one rounding per operation (a fused
    CUDA cross product may contract a*b - c*d into an FMA; these separate
    ops round the same on the card and the host)."""
    return torch.stack([
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
    ], dim=-1)


def convex_hull_mask(positions: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact 3D convex-hull vertex set by the brute-force facet test:
    dense up to 64 keyframes, blocked above (the dense form is O(K^4))."""
    if positions.shape[0] <= 64:
        return _convex_hull_mask_dense(positions, valid)
    return _convex_hull_mask_blocked(positions, valid)


def _convex_hull_mask_dense(
    positions: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    K = positions.shape[0]
    p = positions
    v = valid
    n_valid = v.sum()
    scale = torch.max(torch.where(v[:, None], torch.abs(p), 0.0))
    d1 = p[:, None, :] - p[None, :, :]
    n = torch.linalg.cross(d1[:, :, None, :], d1[:, None, :, :], dim=-1)  # (K,K,K,3)
    nn = torch.sqrt(torch.sum(n * n, dim=-1))
    ok = (
        v[:, None, None] & v[None, :, None] & v[None, None, :]
        & (nn > 1e-6 * scale * scale)
    )
    sp = _dot3(n[:, :, :, None, :], p[None, None, None, :, :])  # (K,K,K,K)
    off = _dot3(n, p[:, None, None, :])  # (K,K,K)
    smax = torch.amax(torch.where(v[None, None, None, :], sp, -3e37), dim=-1)
    smin = torch.amin(torch.where(v[None, None, None, :], sp, 3e37), dim=-1)
    tol = 1e-5 * scale * torch.clamp_min(nn, 1e-30)
    upper = smax - off
    lower = smin - off
    near = (upper <= tol) & (lower >= -tol)
    facet = ok & ~near & ((upper <= tol) | (lower >= -tol))
    mask = (
        torch.any(torch.any(facet, dim=2), dim=1)
        | torch.any(torch.any(facet, dim=2), dim=0)
        | torch.any(torch.any(facet, dim=1), dim=0)
    )
    any_facet = torch.any(facet)

    # exactly-coplanar fallback: exact 2D XY edge test over (K,K) pairs;
    # collinear-in-XY sets mark every pair -> all-valid
    e = -d1[..., :2]
    n2 = torch.stack([-e[..., 1], e[..., 0]], dim=-1)  # (K,K,2)
    nn2 = torch.sqrt(torch.sum(n2 * n2, dim=-1))
    ok2 = v[:, None] & v[None, :] & (nn2 > 1e-9)
    p2 = p[:, :2]
    sp2 = n2[:, :, None, 0] * p2[None, None, :, 0] + n2[:, :, None, 1] * p2[None, None, :, 1]
    off2 = n2[..., 0] * p2[:, None, 0] + n2[..., 1] * p2[:, None, 1]
    tol2 = 1e-5 * scale * torch.clamp_min(nn2, 1e-30)
    smax2 = torch.amax(torch.where(v[None, None, :], sp2, -3e37), dim=-1)
    smin2 = torch.amin(torch.where(v[None, None, :], sp2, 3e37), dim=-1)
    edge = ok2 & (((smax2 - off2) <= tol2) | ((smin2 - off2) >= -tol2))
    mask2 = torch.any(edge, dim=1) | torch.any(edge, dim=0)
    mask2 = torch.where(torch.any(mask2), mask2, valid)

    mask = torch.where(any_facet, mask, mask2) & valid
    return torch.where(n_valid >= 4, mask, torch.zeros_like(mask))


def _convex_hull_mask_blocked(
    positions: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """The JAX package's blocked form: UNIT facet normals and an absolute
    plane tolerance (the dense form scales it by |n| instead)."""
    BLOCKED_CALLS["convex"] += 1
    K, dev = positions.shape[0], positions.device
    p, v = positions, valid
    scale = torch.max(torch.where(v[:, None], torch.abs(p), 0.0))
    tol = 1e-5 * scale
    mask = torch.zeros((K + 1,), dtype=torch.bool, device=dev)
    any_facet = torch.zeros((), dtype=torch.bool, device=dev)
    for ii, jj, kk in _blocks(K, 3, dev):
        a = p[ii]
        nrm = _cross3(p[jj] - a, p[kk] - a)
        nn = torch.sqrt(_dot3(nrm, nrm))
        ok = v[ii] & v[jj] & v[kk] & (nn > 1e-6 * scale * scale)
        nrm = nrm / torch.clamp_min(nn, 1e-12)[:, None]
        s = _dot3(nrm[:, None, :], p[None, :, :]) - _dot3(nrm, a)[:, None]  # (B, K)
        s = torch.where(v[None, :], s, 0.0)
        near = torch.all(torch.abs(s) <= tol, dim=1)
        facet = ok & ~near & (torch.all(s <= tol, dim=1) | torch.all(s >= -tol, dim=1))
        _mark(mask, facet, ii, jj, kk)
        any_facet = any_facet | torch.any(facet)

    # exactly-coplanar fallback: the 2D XY edge test over pairs
    mask2 = torch.zeros((K + 1,), dtype=torch.bool, device=dev)
    p2 = p[:, :2]
    for ii, jj in _blocks(K, 2, dev):
        a = p2[ii]
        d = p2[jj] - a
        nrm = torch.stack([-d[:, 1], d[:, 0]], dim=1)
        nn = torch.sqrt(nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1])
        ok = v[ii] & v[jj] & (nn > 1e-9)
        nrm = nrm / torch.clamp_min(nn, 1e-12)[:, None]
        s = (nrm[:, None, 0] * p2[None, :, 0] + nrm[:, None, 1] * p2[None, :, 1]) - (
            nrm[:, 0] * a[:, 0] + nrm[:, 1] * a[:, 1]
        )[:, None]
        s = torch.where(v[None, :], s, 0.0)
        edge = ok & (torch.all(s <= tol, dim=1) | torch.all(s >= -tol, dim=1))
        _mark(mask2, edge, ii, jj)
    mask, mask2 = mask[:K], mask2[:K]
    mask2 = torch.where(torch.any(mask2), mask2, v)
    mask = torch.where(any_facet, mask, mask2) & v
    return torch.where(v.sum() >= 4, mask, torch.zeros_like(mask))


def concave_hull_mask(
    positions: torch.Tensor, valid: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Exact 2D alpha-shape boundary by the brute-force alpha-complex
    test (computeConcaveHull, odom.cc:1030-1065): dense up to 64
    keyframes, blocked above."""
    if positions.shape[0] <= 64:
        return _concave_hull_mask_dense(positions, valid, alpha)
    return _concave_hull_mask_blocked(positions, valid, alpha)


def _concave_hull_mask_dense(
    positions: torch.Tensor, valid: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    p2 = positions[:, :2]
    v = valid
    alpha = torch.as_tensor(alpha, dtype=positions.dtype, device=positions.device)
    scale = torch.max(torch.where(v[:, None], torch.abs(p2), 0.0))
    tol = 1e-4 * scale
    ab = p2[None, :, :] - p2[:, None, :]  # ab[i,j] = p_j - p_i
    la = torch.sum(ab * ab, dim=-1)  # (K,K)
    dxy = 2.0 * (
        ab[:, :, None, 0] * ab[:, None, :, 1]
        - ab[:, :, None, 1] * ab[:, None, :, 0]
    )  # 4 * signed_area(i,j,k)
    R = torch.sqrt(
        la[:, :, None] * la[:, None, :] * la.T[None, :, :]
    ) / torch.clamp_min(torch.abs(dxy), 1e-12)
    ok = (
        v[:, None, None] & v[None, :, None] & v[None, None, :]
        & (torch.abs(dxy) > 1e-9)
    )
    # emptiness by the inCircle determinant (differences first)
    dx = p2[:, None, 0] - p2[None, :, 0]  # [m, l] = p_m - p_l
    dy = p2[:, None, 1] - p2[None, :, 1]
    q = dx * dx + dy * dy
    m1 = dy[:, None, :] * q[None, :, :] - q[:, None, :] * dy[None, :, :]
    m2 = dx[:, None, :] * q[None, :, :] - q[:, None, :] * dx[None, :, :]
    m3 = dx[:, None, :] * dy[None, :, :] - dy[:, None, :] * dx[None, :, :]
    det = (
        dx[:, None, None, :] * m1[None, :, :, :]
        - dy[:, None, None, :] * m2[None, :, :, :]
        + q[:, None, None, :] * m3[None, :, :, :]
    )
    sgn = torch.sign(dxy)
    thr = torch.abs(dxy) * torch.clamp_min(2.0 * R * tol - tol * tol, 0.0) * 0.5
    inside = (det * sgn[..., None] > thr[..., None]) & v[None, None, None, :]
    kept = ok & (R <= alpha) & ~torch.any(inside, dim=-1)
    in_kept = (
        torch.any(torch.any(kept, dim=2), dim=1)
        | torch.any(torch.any(kept, dim=2), dim=0)
        | torch.any(torch.any(kept, dim=1), dim=0)
    )
    # boundary edges by the alpha-exposure test: an in-complex edge is
    # boundary iff one of its two alpha-disks is empty
    e_ok = v[:, None] & v[None, :] & (la <= 4.0 * alpha * alpha) & (la > 1e-12)
    mid = 0.5 * (p2[:, None, :] + p2[None, :, :])  # (K,K,2)
    h = torch.sqrt(torch.clamp_min(alpha * alpha - la / 4.0, 0.0))
    perp = torch.stack([-ab[..., 1], ab[..., 0]], dim=-1) / torch.sqrt(
        torch.clamp_min(la, 1e-12)
    )[..., None]

    def disk_empty(c):
        d2 = torch.sum((c[:, :, None, :] - p2[None, None, :, :]) ** 2, dim=-1)
        ins = (d2 < (alpha - tol) ** 2) & v[None, None, :]
        return ~torch.any(ins, dim=-1)

    exposed = e_ok & (
        disk_empty(mid + h[..., None] * perp) | disk_empty(mid - h[..., None] * perp)
    )
    boundary = (torch.any(exposed, dim=1) | ~in_kept) & v
    return torch.where(v.sum() >= 5, boundary, torch.zeros_like(boundary))


def _concave_hull_mask_blocked(
    positions: torch.Tensor, valid: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """The JAX package's blocked form: emptiness by the circumcenter
    distance (``dist < R - tol``, the triangle's own corners excluded),
    then the alpha-exposure disk test over pairs."""
    BLOCKED_CALLS["concave"] += 1
    K, dev = positions.shape[0], positions.device
    p2, v = positions[:, :2], valid
    alpha = torch.as_tensor(alpha, dtype=positions.dtype, device=dev)
    scale = torch.max(torch.where(v[:, None], torch.abs(p2), 0.0))
    tol = 1e-4 * scale
    ar = torch.arange(K, device=dev)[None, :]

    # pass 1 (triples): alpha-complex membership per point
    in_kept = torch.zeros((K + 1,), dtype=torch.bool, device=dev)
    for ii, jj, kk in _blocks(K, 3, dev):
        a = p2[ii]
        ab, ac = p2[jj] - a, p2[kk] - a
        d = 2.0 * (ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0])
        la = ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1]
        lc = ac[:, 0] * ac[:, 0] + ac[:, 1] * ac[:, 1]
        inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1.0)
        cx = a[:, 0] + (ac[:, 1] * la - ab[:, 1] * lc) * inv
        cy = a[:, 1] + (ab[:, 0] * lc - ac[:, 0] * la) * inv
        rx, ry = a[:, 0] - cx, a[:, 1] - cy
        R = torch.sqrt(rx * rx + ry * ry)
        ok = v[ii] & v[jj] & v[kk] & (torch.abs(d) > 1e-9)
        dx = cx[:, None] - p2[None, :, 0]
        dy = cy[:, None] - p2[None, :, 1]
        dist = torch.sqrt(dx * dx + dy * dy)  # (B, K)
        inside = (
            (dist < R[:, None] - tol) & v[None, :]
            & (ar != ii[:, None]) & (ar != jj[:, None]) & (ar != kk[:, None])
        )
        kept = ok & (R <= alpha) & ~torch.any(inside, dim=1)
        _mark(in_kept, kept, ii, jj, kk)

    # pass 2 (pairs): boundary edges by the alpha-exposure disk test
    bnd = torch.zeros((K + 1,), dtype=torch.bool, device=dev)
    r2 = (alpha - tol) ** 2
    for ii, jj in _blocks(K, 2, dev):
        a, b = p2[ii], p2[jj]
        ab = b - a
        la = ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1]
        ok = v[ii] & v[jj] & (la <= 4.0 * alpha * alpha) & (la > 1e-12)
        mid = 0.5 * (a + b)
        h = torch.sqrt(torch.clamp_min(alpha * alpha - la / 4.0, 0.0))
        perp = torch.stack([-ab[:, 1], ab[:, 0]], dim=1) / torch.sqrt(
            torch.clamp_min(la, 1e-12)
        )[:, None]

        def disk_empty(c):
            ex = c[:, None, 0] - p2[None, :, 0]
            ey = c[:, None, 1] - p2[None, :, 1]
            ins = (ex * ex + ey * ey < r2) & v[None, :]
            return ~torch.any(ins, dim=1)

        exposed = ok & (
            disk_empty(mid + h[:, None] * perp) | disk_empty(mid - h[:, None] * perp)
        )
        _mark(bnd, exposed, ii, jj)
    mask = (bnd[:K] | ~in_kept[:K]) & v
    return torch.where(v.sum() >= 5, mask, torch.zeros_like(mask))


def exact_hull_masks(
    positions: np.ndarray, valid: np.ndarray, alpha: float
) -> Tuple[np.ndarray, np.ndarray]:
    """EXACT hull memberships on the host (scipy qhull + alpha shape):
    the oracle of the device hulls and the ``hulls="exact"`` replay mode.

    - convex: qhull vertices (what pcl::ConvexHull returns), empty below
      4 valid keyframes (odom.cc:999-1001); a coplanar set takes every
      point on the boundary of its XY hull, a collinear one every point.
    - concave: 2D alpha shape (pcl::ConcaveHull with setAlpha,
      odom.cc:1034): Delaunay triangles with circumradius <= alpha kept;
      boundary = edges on exactly one kept triangle, plus points in no
      kept triangle. Empty below 5 keyframes (odom.cc:1036-1038).
    """
    from scipy.spatial import ConvexHull, Delaunay, QhullError

    K = len(positions)
    vidx = np.nonzero(np.asarray(valid))[0]
    pos = np.asarray(positions, dtype=np.float64)[vidx]
    cv = np.zeros(K, bool)
    cc = np.zeros(K, bool)
    if len(vidx) >= 4:
        try:
            cv[vidx[ConvexHull(pos).vertices]] = True
        except QhullError:
            try:
                hull2 = ConvexHull(pos[:, :2])
                eqs = hull2.equations  # (F, 3): A @ p + b <= 0 inside
                d = eqs[:, :2] @ pos[:, :2].T + eqs[:, 2:3]
                span = max(float(np.abs(pos).max()), 1.0)
                cv[vidx[np.max(d, axis=0) > -1e-6 * span]] = True
            except QhullError:
                cv[vidx] = True
    if len(vidx) >= 5:
        try:
            tri = Delaunay(pos[:, :2])
            a = pos[tri.simplices[:, 0], :2]
            b = pos[tri.simplices[:, 1], :2]
            c = pos[tri.simplices[:, 2], :2]
            la = np.linalg.norm(b - c, axis=1)
            lb = np.linalg.norm(a - c, axis=1)
            lc = np.linalg.norm(a - b, axis=1)
            ab, ac = b - a, c - a
            area = np.abs(ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0]) / 2.0
            R = np.where(
                area > 1e-12, la * lb * lc / (4.0 * np.maximum(area, 1e-12)),
                np.inf,
            )
            kept = tri.simplices[R <= float(alpha)]
            in_kept = np.zeros(len(pos), bool)
            edges = {}
            for s in kept:
                in_kept[s] = True
                for e in ((s[0], s[1]), (s[1], s[2]), (s[0], s[2])):
                    e = (min(e), max(e))
                    edges[e] = edges.get(e, 0) + 1
            bnd = np.zeros(len(pos), bool)
            for (i, j), cnt in edges.items():
                if cnt == 1:
                    bnd[i] = bnd[j] = True
            bnd |= ~in_kept
            cc[vidx[bnd]] = True
        except QhullError:
            cc[vidx] = True
    return cv, cc


# ---------------------------------------------------------------------------
# Submap selection
# ---------------------------------------------------------------------------


def _top_k_ties_mask(ds: torch.Tensor, eligible: torch.Tensor, k: int) -> torch.Tensor:
    """Every eligible frame whose distance <= the k-th smallest eligible
    distance (pushSubmapIndices, odom.cc:1180-1213)."""
    d = torch.where(eligible, ds, _INF)
    k = min(k, d.shape[0])
    # the k-th value of a sort: kthvalue on the card has no deterministic
    # implementation, which the point-parallel step requires
    kth = torch.sort(d).values[k - 1]
    return eligible & (d <= kth)


def select_submap(
    store: KeyframeStore,
    current_pos: torch.Tensor,
    alpha: torch.Tensor,
    knn: int,
    kcv: int,
    kcc: int,
    cv_mask: torch.Tensor | None = None,
    cc_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Union submap selection mask over keyframe slots (odom.cc:1215-1283);
    the exact on-device hulls are computed inline unless given."""
    ds = torch.linalg.vector_norm(store.positions - current_pos, dim=1)
    sel = _top_k_ties_mask(ds, store.valid, knn)
    cv = (
        convex_hull_mask(store.positions, store.valid)
        if cv_mask is None
        else cv_mask & store.valid
    )
    sel = sel | _top_k_ties_mask(ds, cv, kcv)
    cc = (
        concave_hull_mask(store.positions, store.valid, alpha)
        if cc_mask is None
        else cc_mask & store.valid
    )
    return sel | _top_k_ties_mask(ds, cc, kcc)


def gather_submap(
    store: KeyframeStore,
    sel: torch.Tensor,
    max_slots: int,
    capacity: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate the selected keyframes' clouds + covariances into the
    fixed submap buffer (odom.cc:1290-1314).

    Selected slots come first, stable by slot index, cut to ``max_slots``.
    With ``capacity`` the per-keyframe blocks are compacted by the JAX
    package's block copies: slot i writes its FULL P-row block at its
    cumulative valid offset (the next slot overwrites the sentinel tail),
    the start clamped to ``capacity`` like ``dynamic_update_slice`` into
    a buffer with a P-row scratch tail, which drops overflow. Here each
    output row gathers from the last block that covers it, with no host
    read.

    Returns (points (S,3), mask (S,), covs (S,3,3)), S = capacity or
    max_slots * P.
    """
    order = torch.argsort(torch.where(sel, 0, 1), stable=True)[:max_slots]
    picked = sel[order]
    pts = store.points[order]  # (S_kf, P, 3)
    msk = store.masks[order] & picked[:, None]
    cvs = store.covs[order]
    P = store.points.shape[1]
    pts = torch.where(msk[..., None], pts, SENTINEL)
    if capacity is None:
        S = max_slots * P
        return pts.reshape(S, 3), msk.reshape(S), cvs.reshape(S, 3, 3)

    cnt = msk.sum(dim=1)
    # slot i's block starts at its cumulative count, clamped to capacity
    # (non-decreasing); a row's source is the LAST slot whose block
    # covers it, as the JAX package's block writes leave it (each block
    # overwrites the previous one's sentinel tail), found on the device
    offs = torch.clamp_max(torch.cumsum(cnt, 0) - cnt, capacity)
    eye = torch.eye(3, dtype=cvs.dtype, device=cvs.device)
    cvs = torch.where(msk[..., None, None], cvs, eye)
    rows = torch.arange(capacity, dtype=offs.dtype, device=pts.device)
    src = torch.searchsorted(offs, rows, right=True) - 1
    src_c = src.clamp_min(0)
    k = rows - offs[src_c]
    cover = (src >= 0) & (k < P)
    k = k.clamp(0, P - 1)
    out_p = torch.where(cover[:, None], pts[src_c, k], SENTINEL)
    out_c = torch.where(cover[:, None, None], cvs[src_c, k], eye)
    total = torch.clamp_max(cnt.sum(), capacity)
    out_msk = torch.arange(capacity, device=pts.device) < total
    return out_p, out_msk, out_c
