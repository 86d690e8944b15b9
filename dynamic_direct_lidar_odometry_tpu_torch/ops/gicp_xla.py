"""GICP's linearization sums rounded as the JAX package's jitted
``gicp.align`` rounds them on the CPU (XLA, x86-64 with FMA).

Read from the compiled module (``XLA_FLAGS=--xla_dump_to=DIR``: the
optimized HLO, each fusion's LLVM IR and the disassembly of its object):

- XLA emits the K = 3 products (R C R^T, M e, M J), the 4x4 compose and
  the 3x3 inverse as loops of its own, and its code generator contracts
  each multiply that feeds an add into one FMA: a K = 3 dot is
  ``fma(a2, b2, fma(a1, b1, a0 * b0))``; so is the point transform and
  every ``v - p q`` of the LDLT solve (``sub``).
- The error sum (``jnp.sum(e * Me)``) is a tree: windows of 32 rows
  (x 3 columns), each one vectorized loop over 8 lanes (``tree_sum``),
  then the window sums in order, padded with zeros split around them.
- ``b`` sums its 3N terms in the order (column i, point n). Up to 3,072
  terms XLA fuses the dot into one loop: a single FMA chain per entry.
  Above (2,048 points and more) it is Eigen's GEMV (``gemv``).
- ``H`` goes to Eigen's contraction, which has no object to read: its
  grouping of the 3N rows (point n, column i) into partial sums was
  probed with crafted inputs (``tools/torch_jax_gaps.py --probe``) and is
  written out in ``_runs`` / ``_tree4``. From 10,752 rows it follows
  Eigen's 8 threads, which the JAX package's tests get with their 8
  virtual CPU devices; a default JAX process there gives H by core count.

Everything here runs on the host with numpy (the chains are sequential).
It has the names of ``gicp.TORCH``, the card's arithmetic, and
``gicp.arithmetic`` picks this module for host tensors. A lambda trial's
``lm_propose`` and ``lm_decide`` are the LM loop's own torch code over
these pieces.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import se3
from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance

_TREE = 32  # XLA CPU's reduction window (rows)
_SHARD_ROWS = 10752  # from here Eigen shards H's rows over 8 threads
_FUSED_B = 3072  # up to this many rows XLA fuses b's dot into one loop


def _r(x: np.ndarray) -> np.ndarray:
    """f64 -> f32, one rounding, denormals flushed as XLA flushes them."""
    y = np.asarray(x, np.float64).astype(np.float32)
    y[np.abs(y) < np.float32(2.0**-126)] = 0.0
    return y


def _f(x) -> np.ndarray:
    return np.asarray(x, np.float64)


def _mul(a, b):
    return _r(_f(a) * _f(b))


def odd_sum(p, c) -> np.ndarray:
    """numpy twin of ``core.fp.odd_sum``: the f64 ``p + c`` rounded to
    odd (TwoSum's exact error; an inexact sum whose last bit is even
    steps one ulp toward it), so that one more rounding, to f32, is the
    correctly rounded f32 sum."""
    p, c = np.broadcast_arrays(_f(p), _f(c))
    with np.errstate(invalid="ignore"):  # inf - inf in the error of an inf sum
        s = p + c
        pp = s - c
        e = (p - pp) + (c - (s - pp))
    bits = np.asarray(s).view(np.int64)
    odd = (bits - ((e > 0) != (s > 0))) | 1
    return np.where((e != 0) & np.isfinite(e), odd, bits).view(np.float64)


_LOW29, _MID29 = (1 << 29) - 1, 1 << 28  # the f64 fraction bits below f32's
_F32_TINY = 897 << 52  # the f64 bits of 2^-126: below it f32 is subnormal


def _misrounds(s: np.ndarray, p: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Where ``s``, the f64 sum of ``p + c``, may round to f32 otherwise
    than the exact sum: an inexact ``s`` on an f32 midpoint or in f32's
    subnormal range (each f32 rounding boundary is an f64 number, so the
    exact sum lies on the same side of it as its f64 rounding unless that
    lands on it). ``s - p == c`` and ``s - c == p`` both hold only for an
    exact sum (Fast2Sum: the difference with the larger term is exact)."""
    t = s.view(np.int64) & 0x7FFFFFFFFFFFFFFF
    near = ((t & _LOW29) == _MID29) | ((t < _F32_TINY) & (t != 0))
    with np.errstate(invalid="ignore"):
        return near & ((s - p != c) | (s - c != p))


def fma32(a, b, c) -> np.ndarray:
    """numpy twin of ``core.fp.fma32``: f32 ``a * b + c`` with one
    rounding (the f64 product of two f32 is exact), denormals kept."""
    return odd_sum(_f(a) * _f(b), c).astype(np.float32)


def _fma(a, b, c):
    return _r(odd_sum(_f(a) * _f(b), c))


def dot3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sum_k a[..., k] b[..., k] over a last axis of 3, as XLA's loop."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], _mul(a[..., 0], b[..., 0])))


# the point transform with XLA's contraction (on every device)
transform_points = se3.transform_points


def sub(v: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``v - p q`` of ``gicp.solve6_ldlt`` as one FMA, ``fma(-p, q, v)``
    (``p`` is ``L L`` rounded in the factorization)."""
    return covariance._fma(-p, q, v)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``se3.compose`` (a 4x4 dot, over any leading batch) as XLA's K = 4
    loop: an FMA chain."""
    a = A.numpy()[..., :, None, :]
    b = np.swapaxes(B.numpy(), -1, -2)[..., None, :, :]
    acc = _mul(a[..., 0], b[..., 0])
    for k in range(1, 4):
        acc = _fma(a[..., k], b[..., k], acc)
    return torch.from_numpy(acc)


def se3_exp(d: torch.Tensor) -> torch.Tensor:
    """``se3.se3_exp`` (twists (..., 6)) as XLA rounds it: the angle's
    square a K = 3 loop, root, sine, cosine and quotient correctly rounded,
    and each off-diagonal ``u v -/+ w z`` of the rotation
    ``fma(-/+w, z, u v)``."""
    d = d.numpy()
    om, t = d[..., :3], d[..., 3:]
    ts = dot3(om, om)
    small = ts < np.float32(1e-10)
    th = _r(np.sqrt(np.maximum(_f(ts), 1e-12)))
    half = _mul(np.float32(0.5), th)
    imag = np.where(small, _r(0.5 - _f(_mul(np.float32(1.0 / 48.0), ts))),
                    _r(_f(_r(np.sin(_f(half)))) / _f(th)))
    real = np.where(small, _r(1.0 - _f(_mul(np.float32(0.125), ts))), _r(np.cos(_f(half))))
    w = real
    x, y, z = (_mul(imag, om[..., i]) for i in range(3))

    def diag(u, v):
        return _r(1.0 - 2.0 * _f(_fma(v, v, _mul(u, u))))

    def off(u, v, w_, z_, sgn):
        return _r(2.0 * _f(_fma(sgn * w_, z_, _mul(u, v))))

    R = np.stack([
        np.stack([diag(y, z), off(x, y, w, z, -1), off(x, z, w, y, 1)], -1),
        np.stack([off(x, y, w, z, 1), diag(x, z), off(y, z, w, x, -1)], -1),
        np.stack([off(x, z, w, y, -1), off(y, z, w, x, 1), diag(x, y)], -1),
    ], -2)
    T = np.zeros(d.shape[:-1] + (4, 4), np.float32)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return torch.from_numpy(T)


def lm_propose(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor, zero=None):
    """A lambda trial's step, as ``gicp.lm_propose``: ``gicp.lm_propose_plain``
    with every ``v - p q`` of the solve one FMA (:func:`sub`) and
    :func:`se3_exp`."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    return gicp.lm_propose_plain(H, b, lam, zero, sub=sub, exp=se3_exp)


def _dots(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``d . g`` a ``torch.dot`` per stream."""
    return torch.dot(d, g) if d.dim() == 1 else torch.stack([torch.dot(u, v) for u, v in zip(d, g)])


def lm_decide(y0, yi, d, b, delta, xi, st, s) -> None:
    """The rest of a lambda trial, as ``gicp.lm_decide``: ``gicp.lm_decide_plain``
    (``st`` a ``gicp.TrialState``, updated in place) with the denominator
    ``d . (lam d - b)`` a ``torch.dot`` per stream."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    gicp.lm_decide_plain(y0, yi, d, b, delta, xi, st, s, dot=_dots)


def rcar(R: np.ndarray, C: np.ndarray) -> np.ndarray:
    """R C R^T per point: (R C) first, then (R C) R^T, each a K = 3 loop."""
    RC = dot3(R[None, :, None, :], np.swapaxes(C, 1, 2)[:, None, :, :])
    return dot3(RC[:, :, None, :], R[None, None, :, :])


def inv3x3(m: np.ndarray) -> np.ndarray:
    """``gicp.inv3x3`` with XLA's contractions: each 2x2 minor
    ``fma(x, y, -(z w))``, ``det = fma(c, C, fma(a, A, b B))``."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def minor(x, y, z, w):
        return _fma(x, y, -_mul(z, w))

    A, B, C = minor(e, i, f, h), -minor(d, i, f, g), minor(d, h, e, g)
    D, E, F = -minor(b, i, c, h), minor(a, i, c, g), -minor(a, h, b, g)
    G, H, I = minor(b, f, c, e), -minor(a, f, c, d), minor(a, e, b, d)  # noqa: E741
    det = _fma(c, C, _fma(a, A, _mul(b, B)))
    det = np.where(np.abs(det) < np.float32(1e-20), np.float32(1e-20), det)
    inv_det = _r(1.0 / _f(det))
    adj = np.stack([np.stack([A, D, G], -1), np.stack([B, E, H], -1),
                    np.stack([C, F, I], -1)], -2)
    return _mul(adj, inv_det[..., None, None])


def _pad_rows(v: np.ndarray, nwin: int) -> np.ndarray:
    """XLA's tree pads a row count up to whole windows with zeros split
    around it: half (rounded down) before, the rest after."""
    pad = nwin * _TREE - v.shape[0]
    z = np.zeros((pad,) + v.shape[1:], np.float32)
    return np.concatenate([z[: pad // 2], v, z[pad // 2:]])


def tree_sum(x: np.ndarray) -> np.ndarray:
    """``jnp.sum`` of an (N, 3) f32 array in XLA's CPU tree order: each
    window of 32 rows is one vectorized loop (lane l adds rows l, l + 8,
    l + 16, l + 24, three columns each, then the 8 lanes fold as
    ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7))); the window sums
    are added in order, in windows of 32 while more than 32 remain."""
    nwin = -(-x.shape[0] // _TREE)
    v = _pad_rows(x.astype(np.float32), nwin).reshape(nwin, _TREE // 8, 8, 3)
    lanes = np.zeros((nwin, 8), np.float32)
    for it in range(_TREE // 8):
        for c in range(3):
            lanes = lanes + v[:, it, :, c]
    a = lanes[:, :4] + lanes[:, 4:]
    v = ((a[:, 0] + a[:, 2]) + (a[:, 1] + a[:, 3]))
    while v.shape[0] > _TREE:
        nwin = -(-v.shape[0] // _TREE)
        v = np.add.accumulate(_pad_rows(v, nwin).reshape(nwin, _TREE), axis=1)[:, -1]
    return np.add.accumulate(v)[-1]


def fma_chain(a: np.ndarray, b: np.ndarray, acc=0.0) -> np.ndarray:
    """acc = fma(a[k], b[k], acc) for k in order: (K, ...) -> (...).

    The chain runs with plain f64 sums, each kept; afterwards one check
    over all of them finds the first step whose sum may round otherwise
    than its exact value (:func:`_misrounds`: about 2^-29 of the inexact
    sums), which is redone with the odd sum, and the chain resumed from
    there."""
    p = _f(a) * _f(b)
    K = p.shape[0]
    acc0 = np.broadcast_to(_f(acc), p.shape[1:])
    sums = np.empty(p.shape)
    start, acc = 0, acc0
    while start < K:
        for k in range(start, K):
            np.add(acc, p[k], out=sums[k])
            acc = sums[k].astype(np.float32).astype(np.float64)
        prev = np.concatenate([acc0[None] if start == 0 else sums[start - 1:start],
                               sums[start:K - 1]]).astype(np.float32).astype(np.float64)
        bad = _misrounds(sums[start:], p[start:], prev).reshape(K - start, -1).any(axis=1)
        if not bad.any():
            break
        k0 = start + int(np.argmax(bad))
        acc = odd_sum(prev[k0 - start], p[k0]).astype(np.float32).astype(np.float64)
        sums[k0] = acc
        start = k0 + 1
    return _r(acc)


def gemv(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    """a^T v for (K, 6) ``a`` as Eigen's row-major GEMV (AVX2 + FMA):
    8 lane-partial FMA chains over each row, folded lo + hi down to one
    lane, then the K mod 8 tail in order."""
    full = a.shape[0] // 8 * 8
    lanes = fma_chain(a[:full].reshape(-1, 8, a.shape[1]), v[:full].reshape(-1, 8, 1))
    while lanes.shape[0] > 1:
        h = lanes.shape[0] // 2
        lanes = _r(_f(lanes[:h]) + _f(lanes[h:]))
    return fma_chain(a[full:], v[full:, None], lanes[0])


def _runs(K: int) -> list:
    """How XLA's CPU dot groups the K rows of ``A^T B`` into partial sums
    (read with ``tools/torch_jax_gaps.py --probe``): a list of chunks,
    each a list of (start, end) runs. A run is one FMA chain; a chunk adds
    its runs in order.

    - Below 10,752 rows, one chunk of S = 2 ceil(K / 608) runs (2 below
      1,536 rows): S - 2 runs of ceil4(K / S) rows, the rest halved into
      the last two.
    - From 10,752 rows, 8 chunks of ceil8(K / 8) rows (the last shorter),
      each cut into runs of ceil8(c // ceil(c / 320)) rows with the
      remainder last (at these sizes there are always 8); the chunks are
      added as a tree (``_tree4``)."""
    if K >= _SHARD_ROWS:
        size = (-(-K // 8) + 7) // 8 * 8
        chunks = []
        for c0 in range(0, K, size):
            c = min(size, K - c0)
            bk = (c // -(-c // 320) + 7) // 8 * 8
            chunks.append([(c0 + k, c0 + min(k + bk, c)) for k in range(0, c, bk)])
        return chunks
    S = 2 * -(-K // 608) if K >= 1536 else 2
    bk = (-(-K // S) + 3) // 4 * 4
    edges = [i * bk for i in range(S - 1)]
    half = (K - edges[-1]) // 2
    edges += [edges[-1] + half, K]
    return [list(zip(edges[:-1], edges[1:]))]


def _add4(d, s0, s1, s2):
    """Eigen's ``addAllToBuffer``: (d + s0) + (s1 + s2) over whole 8-float
    packets of the flat buffer, d + ((s0 + s1) + s2) over its tail."""
    def add(x, y):
        return _r(_f(x) + _f(y))

    out = add(add(d, s0), add(s1, s2)).reshape(-1)
    tail = out.size // 8 * 8
    out[tail:] = add(d, add(add(s0, s1), s2)).reshape(-1)[tail:]
    return out.reshape(d.shape)


def _tree4(parts: list) -> np.ndarray:
    """Eigen's sum of its 8 inner-dim shards: each group of 4 through
    ``_add4``, then the two groups' sums."""
    return _r(_f(_add4(*parts[:4])) + _f(_add4(*parts[4:])))


def gram(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A^T B for (K, 6) operands in XLA's (Eigen's) order (``_runs``)."""
    p = _f(A)[:, :, None] * _f(B)[:, None, :]
    chunks = []
    for runs in _runs(A.shape[0]):
        acc = np.zeros(p.shape[1:], np.float32)
        for lo, hi in runs:
            acc = _r(_f(acc) + _f(fma_chain(p[lo:hi], 1.0)))
        chunks.append(acc)
    return chunks[0] if len(chunks) == 1 else _tree4(chunks)


def _residual(src_t, vf, M, B):
    """e = (B - T a) masked, and M e."""
    e = _mul(_r(_f(B) - _f(src_t)), vf[:, None])
    return e, dot3(M, e[:, None, :])


def _per_stream(fn, *args):
    """``fn`` of single-stream arguments, over a leading batch axis when
    the first argument has one (3 dims); ``fn`` returns a tuple."""
    if args[0].dim() == 3:
        return tuple(torch.stack(v) for v in zip(*(fn(*a) for a in zip(*(x.unbind(0) for x in args)))))
    return fn(*args)


def linearize_terms(src_t, vf, R, cov_B, src_covs, B):
    """The sums of one linearization after the correspondence search, as
    XLA rounds them (per stream over a leading batch axis): returns
    (M, y0, H, b), as ``gicp.TORCH.linearize_terms``.

    ``src_t`` (N, 3) the transformed source (:func:`transform_points`),
    ``vf`` (N,) validity as 0/1, ``R`` the pose's rotation, ``cov_B`` /
    ``B`` the winners' covariances and points, ``src_covs`` the source
    covariances."""
    return _per_stream(_linearize_terms, src_t, vf, R, cov_B, src_covs, B)


def _linearize_terms(src_t, vf, R, cov_B, src_covs, B):
    M = inv3x3(_r(_f(cov_B.numpy()) + _f(rcar(R.numpy(), src_covs.numpy()))))
    e, Me = _residual(src_t.numpy(), vf.numpy(), M, B.numpy())
    y0 = tree_sum(_mul(e, Me))
    S = se3.skew(src_t)
    J = torch.cat([S, -torch.eye(3).expand_as(S)], dim=-1).numpy() * vf.numpy()[:, None, None]
    MJ = dot3(M[:, :, None, :], np.swapaxes(J, 1, 2)[:, None, :, :])
    N = J.shape[0]
    H = gram(J.reshape(3 * N, 6), MJ.reshape(3 * N, 6))
    Jt, Mt = np.swapaxes(J, 0, 1).reshape(3 * N, 6), Me.T.reshape(3 * N)
    b = fma_chain(Jt, Mt[:, None]) if 3 * N <= _FUSED_B else gemv(Jt, Mt)
    t = torch.from_numpy
    return t(M), torch.tensor(y0), t(H), t(b)


def error(src_t, vf, M, B):
    """sum e^T M e with the weights held (per stream over a leading batch
    axis)."""
    return _per_stream(_error, src_t, vf, M, B)[0]


def _error(src_t, vf, M, B):
    e, Me = _residual(src_t.numpy(), vf.numpy(), M.numpy(), B.numpy())
    return (torch.tensor(tree_sum(_mul(e, Me))),)
