"""Optimal linear assignment (counterpart of ``ops/hungarian.py``).

The Jonker-Volgenant successive-shortest-augmenting-path solve on a
padded N x N cost matrix, with the JAX package's f32 arithmetic. Its two
``lax.while_loop``s depend on the data; here they are Python loops over
tensors that stay on the cost's device: the shortest-path loop reads one
value pair back to the host per step (the next column and whether it is
free), and the augmentation reads the ``way`` array once per inserted
row. :data:`HOST_READS` counts those reads.
"""

from __future__ import annotations

import collections

import torch

BIG = 1.0e6
_INF = 3.0e12

# host reads by loop ("path" per shortest-path step, "augment" per row,
# "rows" per solve)
HOST_READS: collections.Counter = collections.Counter()


def solve(cost: torch.Tensor, row_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Minimum-cost assignment on a square (N, N) matrix: col_of_row (N,)
    int32, -1 for skipped rows. ``row_valid`` rows that are False are not
    inserted (their result is -1 or, see below, the JAX scatter's value)."""
    N = cost.shape[0]
    dev = cost.device
    C = torch.nn.functional.pad(cost.to(torch.float32), (1, 0, 1, 0))  # 1-indexed
    u = torch.zeros(N + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(N + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(N + 1, dtype=torch.long, device=dev)  # p[j] = row of col j
    way = torch.zeros(N + 1, dtype=torch.long, device=dev)
    cols = torch.arange(N + 1, device=dev)
    real_col = cols >= 1
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    if row_valid is None:
        rows = range(1, N + 1)
    else:
        HOST_READS["rows"] += 1
        rows = [i + 1 for i in torch.nonzero(row_valid).reshape(-1).tolist()]

    for i in rows:
        p[0] = i
        minv = torch.full((N + 1,), _INF, dtype=torch.float32, device=dev)
        used = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        j0 = 0
        while True:
            # (1,)-shaped device indices throughout: indexing with a 0-d
            # tensor would read it back to the host
            used[j0] = True
            i0 = p[j0 : j0 + 1]
            cur = (C.index_select(0, i0)[0] - u.index_select(0, i0)) - v
            better = ~used & real_col & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            cand = torch.where(~used & real_col, minv, _INF)
            j1 = torch.argmin(cand).reshape(1)
            delta = cand.gather(0, j1)
            # u[p[j]] += delta, v[j] -= delta for the used columns
            u = u.index_add(0, p, torch.where(used, delta, zero))
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            HOST_READS["path"] += 1
            j0, free = torch.cat([j1, p.gather(0, j1)]).tolist()
            if free == 0:
                break
        # augment along the alternating path
        HOST_READS["augment"] += 1
        way_h = way.tolist()
        while j0 != 0:
            j1 = way_h[j0]
            p[j0] = p[j1]
            j0 = j1

    # col_of_row[p[j] - 1] = j for every column j. The JAX package scatters
    # this with NumPy index rules: an unassigned column (p = 0) writes to
    # index -1, i.e. the last row, and on its CPU backend the last write
    # in column order wins. Reproduced deterministically.
    dst = p[1:] - 1
    dst = torch.where(dst < 0, dst + N, dst)
    hits = dst[None, :] == torch.arange(N, device=dev)[:, None]  # (row, col)
    last = torch.amax(torch.where(hits, cols[1:][None, :], 0), dim=1)
    return (last - 1).to(torch.int32)


def assign(
    cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor
) -> torch.Tensor:
    """Rectangular masked assignment (HungarianAlgorithm::Solve semantics,
    tracking.cpp:118-127): (R,) int32 assigned col per row, -1 if
    unassigned or invalid."""
    R, Cc = cost.shape
    N = max(R, Cc)
    dev = cost.device
    pad = torch.full((N, N), BIG, dtype=torch.float32, device=dev)
    ok = row_valid[:, None] & col_valid[None, :]
    pad[:R, :Cc] = torch.where(ok, torch.clamp_max(cost, BIG - 1), BIG)
    rv = torch.zeros(N, dtype=torch.bool, device=dev)
    rv[:R] = row_valid
    col = solve(pad, rv)[:R].long()
    in_range = (col >= 0) & (col < Cc)
    matched = in_range & row_valid & col_valid[col.clamp(0, Cc - 1)]
    # a row assigned to a BIG (invalid) pair is unmatched
    pair_cost = pad[torch.arange(R, device=dev), col.clamp(0, N - 1)]
    matched = matched & (pair_cost < BIG - 0.5)
    return torch.where(matched, col, -1).to(torch.int32)
