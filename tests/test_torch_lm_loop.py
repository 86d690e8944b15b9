"""GICP's whole lambda loop in one launch (``csrc/lm_trial.cu``:
``ddlo_lm_inner``, wrapped by ``ops/gicp.lm_inner``) through its plain
version ``lm_inner_plain``, against the JAX package.

- ``lm_inner_plain`` against a numpy transcription of the JAX package's
  lm_inner (``gicp.py:355-404``: its ``while_loop`` and trial body) run to
  its end, stream by stream, on ``tests/torch_lm_cases.py``'s batches (a
  free loop, a far start, a loop whose every step climbs until
  ``lm_max_iterations``, a step d = 0, a degenerate stream, a stream that
  does not run): the same decisions, flags and trial counts; lambda and
  nu within 1e-6 relative (the decision's own order differs from
  numpy's); the pose and the final step bit for bit; a stream that runs
  no trial keeps its start bit for bit.
- Rounding and order: ``gicp.error_fixed`` against a numpy transcription
  of the kernel's tree (thread t of the cluster summing points t, t + P,
  ... left to right, then lanes, warps and blocks by halving steps) bit
  for bit, on errors spanning nine decades so that the order shows; a
  step d = 0 gives yi == y0 bit for bit and is accepted; batched streams
  are bit-equal to single streams.
- ``align`` and ``align_batch`` with the card's arithmetic
  (``gicp.TORCH``) on the host against the JAX package's ``align`` and
  ``jax.vmap(gicp.align)``, at tests/test_torch_parallel.py's bars
  (T within 1e-5, counts equal): each lambda loop one ``lm_inner`` call.
- On the CPU the wrapper takes the plain version, never a CUDA build;
  other devices raise. The ``gpu`` cases hold the kernel to the plain
  version bit for bit on the card, on the shared-memory route (16,384
  points, a count that is no multiple of P, streams off a 16-byte
  boundary) and the device-memory route (65,536 points), at B = 1 and 8;
  this module imports JAX only inside the CPU cases, so they run on a
  host without it:
  ``python -m pytest --noconftest tests/test_torch_lm_loop.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from test_torch_lm_kernel import _np_trial
from torch_lm_cases import S, inner_case

from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build, gicp

F = np.float32


def _bits(x: torch.Tensor) -> bytes:
    return x.detach().cpu().contiguous().numpy().tobytes()


def _stream(args, s):
    """Stream s of an ``inner_case`` batch, with no batch axis."""
    return [x[s] for x in args]


def _run_plain(args, s=S):
    args = list(args)
    args[1] = args[1].clone()  # lam is updated in place
    return gicp.lm_inner_plain(*args, s)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_loop_matches_the_jax_loop_run_to_its_end(seed):
    args = inner_case(8, 1001, seed=seed)
    st = _run_plain(args)
    eye = np.eye(4, dtype=F)
    for s_ in range(8):
        x0, lam, H, b, src, valid, M, Bv, deg, run = _stream(args, s_)
        if bool(deg) or not bool(run):
            assert int(st.j[s_]) == 0 and not (st.done[s_] or st.accepted[s_] or st.conv[s_] or st.act[s_])
            assert _bits(st.lam[s_]) == _bits(lam) and _bits(st.x[s_]) == _bits(x0)
            assert _bits(st.delta_done[s_]) == eye.tobytes() and float(st.nu[s_]) == 2.0
            continue
        # gicp.py:355-392, the while_loop's cond and body, in numpy; the
        # step, compose and error from the card's plain pieces
        y0 = gicp.error_fixed(x0, src, valid, M, Bv).numpy()
        state = (lam.numpy().copy(), F(2.0), False, False, False, x0.numpy().copy(), eye)
        j = 0
        while j < S.lm_max_iterations and not state[2]:
            d, delta = gicp.lm_propose_plain(H, b, torch.from_numpy(np.asarray(state[0])))
            xi = gicp._compose_ltr(delta, torch.from_numpy(state[5]))
            yi = gicp.error_fixed(xi, src, valid, M, Bv).numpy()
            state = _np_trial(state, d.numpy(), b.numpy(), y0, yi, delta.numpy(), xi.numpy())
            j += 1
        lam_n, nu_n, done, acc, conv, x, dd = state
        assert int(st.j[s_]) == j
        assert (bool(st.done[s_]), bool(st.accepted[s_]), bool(st.conv[s_])) == (done, acc, conv)
        assert bool(st.act[s_]) == (not done)
        np.testing.assert_allclose(st.lam[s_].numpy(), lam_n, rtol=1e-6)
        np.testing.assert_allclose(st.nu[s_].numpy(), nu_n, rtol=1e-6)
        assert _bits(st.x[s_]) == x.tobytes() and _bits(st.delta_done[s_]) == dd.tobytes()
    # the batch's kinds all happened: accepted, run to the cap, no trial
    assert set(st.j.tolist()) >= {0, 1, S.lm_max_iterations}
    assert bool(st.accepted.any()) and bool((st.act & (st.j == S.lm_max_iterations)).any())


def test_batched_streams_equal_single_streams():
    args = inner_case(8, 1001, seed=2)
    st = _run_plain(args)
    for s_ in range(8):
        one = _run_plain(_stream(args, s_))
        for f, a, c in zip(gicp.TrialState._fields, st, one):
            assert _bits(a[s_]) == _bits(c), (s_, f)


def _np_tree(q: np.ndarray) -> np.float32:
    """The kernel's sum of q (N,) f32: thread t = 512 r + i of the cluster
    (block r, thread i) sums points t, t + P, ... left to right (a point
    past N is +0), each warp halves its 32 lanes (v[l] + v[l + h]), each
    block its 16 warp sums, then the cluster its 8 block sums."""
    P, T = gicp.LM_CLUSTER * gicp.LM_THREADS, gicp.LM_THREADS
    N = q.shape[0]
    K = max(1, -(-N // P))
    acc = np.zeros(P, F)
    for t in range(P):
        for r in range(K):
            n = r * P + t
            v = q[n] if n < N else F(0.0)
            acc[t] = v if r == 0 else F(acc[t] + v)

    def halve(v):
        v = v.copy()
        h = len(v) // 2
        while h:
            v[:h] = (v[:h] + v[h:2 * h]).astype(F)
            h //= 2
        return v[0]

    blocks = []
    for c in range(gicp.LM_CLUSTER):
        warps = [halve(acc[c * T + 32 * w:c * T + 32 * (w + 1)]) for w in range(T // 32)]
        blocks.append(halve(np.array(warps, F)))
    return halve(np.array(blocks, F))


def _np_point_errors(T, src, valid, M, B) -> np.ndarray:
    """q = e^T M e per point in the kernel's order, numpy f32 (one
    rounding per operation)."""
    st = [((src[:, 0] * T[r, 0] + src[:, 1] * T[r, 1]) + src[:, 2] * T[r, 2]) + T[r, 3] for r in range(3)]
    vf = valid.astype(F)
    e = [(B[:, r] - st[r]) * vf for r in range(3)]
    me = [(M[:, r, 0] * e[0] + M[:, r, 1] * e[1]) + M[:, r, 2] * e[2] for r in range(3)]
    return ((e[0] * me[0] + e[1] * me[1]) + e[2] * me[2]).astype(F)


def test_fixed_order_error_is_the_kernels_tree():
    """Errors spanning nine decades (points at 1e-3 to 1e6 m from their
    targets, some invalid), 9,000 points (K = 3 rows of P, the last
    partial): error_fixed equals the numpy tree bit for bit, and the
    order shows (a left-to-right sum of the same q differs)."""
    rng = np.random.default_rng(5)
    N, differs = 9000, 0
    for _ in range(3):
        src = rng.uniform(-20, 20, (N, 3)).astype(F)
        B = (src + rng.normal(size=(N, 3)) * 10.0 ** rng.uniform(-3, 6, (N, 1))).astype(F)
        A = rng.normal(size=(N, 3, 3))
        M = (A @ A.transpose(0, 2, 1) + np.eye(3)).astype(F)
        valid = rng.random(N) < 0.9
        T = np.eye(4, dtype=F)
        T[:3, 3] = [0.1, -0.2, 0.3]
        got = gicp.error_fixed(*(torch.from_numpy(x) for x in (T, src, valid, M, B)))
        q = _np_point_errors(T, src, valid, M, B)
        want = _np_tree(q)
        assert got.numpy().tobytes() == want.tobytes()
        ltr = F(0.0)
        for v in q:
            ltr = F(ltr + v)
        differs += ltr != want
    assert differs > 0


def test_zero_step_gives_y0_and_is_accepted():
    """b = 0: d = 0, delta = I, xi = x0 bit for bit, so yi == y0 and rho
    = 0 is accepted: one trial, lambda doubled exactly (the 0/0 guard)."""
    args = inner_case(1, 3000, seed=3, kinds=["d_zero"], lead=False)
    x0, lam, H, b, src, valid, M, Bv, _, _ = args
    d, delta = gicp.lm_propose_plain(H, b, lam)
    xi = gicp._compose_ltr(delta, x0)
    assert not d.any() and _bits(xi) == _bits(x0)
    assert _bits(gicp.error_fixed(xi, src, valid, M, Bv)) == _bits(gicp.error_fixed(x0, src, valid, M, Bv))
    st = _run_plain(args)
    assert int(st.j) == 1 and bool(st.accepted) and bool(st.done) and not bool(st.conv)
    assert _bits(st.lam) == _bits(lam * 2.0) and _bits(st.x) == _bits(x0)


def test_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    """CPU tensors never reach a CUDA build; other devices raise."""
    def no_build(*a, **k):
        raise AssertionError("a CUDA build was reached from CPU tensors")

    monkeypatch.setattr(_cuda_build, "load", no_build)
    monkeypatch.setattr(_cuda_build, "load_all", no_build)
    for lead in (True, False):
        args = inner_case(6 if lead else 1, 700, seed=4, lead=lead)
        a, b = list(args), list(args)
        a[1], b[1] = args[1].clone(), args[1].clone()
        got, want = gicp.lm_inner(*a, S), gicp.lm_inner_plain(*b, S)
        assert all(_bits(x) == _bits(y) for x, y in zip(got, want))
    meta = [x.to("meta") for x in inner_case(2, 64, seed=4)]
    with pytest.raises(ValueError, match="no kernel"):
        gicp.lm_inner(*meta, S)


def _count_inner(monkeypatch):
    calls = {"inner": 0, "split": 0}

    def inner(*a, _fn=gicp.TORCH.lm_inner, **k):
        calls["inner"] += 1
        return _fn(*a, **k)

    def split(*a, _fn=gicp.TORCH.lm_decide, **k):
        calls["split"] += 1
        return _fn(*a, **k)

    monkeypatch.setattr(gicp.TORCH, "lm_inner", inner)
    monkeypatch.setattr(gicp.TORCH, "lm_decide", split)
    monkeypatch.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)
    return calls


def test_card_arithmetic_align_matches_jax(monkeypatch):
    """align on the card's arithmetic (lm_inner's plain version) against
    the JAX package's align, at tests/test_torch_parallel.py's bars."""
    from test_torch_gicp_bits import _inputs

    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp

    T, src, sm, sc, tgt, tm, tc = _inputs(1024, 2)
    guess = np.eye(4, dtype=F)
    ref = jgicp.align(src, sm, sc, tgt, tm, tc, guess, jgicp.GICPSettings())
    calls = _count_inner(monkeypatch)
    got = gicp.align(*(torch.from_numpy(np.array(x)) for x in (src, sm, sc, tgt, tm, tc, guess)),
                     gicp.GICPSettings())
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-5)
    for f in ("iterations", "num_inliers", "converged"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    assert calls["inner"] == int(got.iterations) > 0 and calls["split"] == 0


def test_card_arithmetic_align_batch_matches_jax_vmap(monkeypatch):
    """align_batch on the card's arithmetic against jax.vmap(gicp.align)
    on tests/test_torch_parallel.py's "varied" case (streams that stop at
    different iterations, a masked one, a degenerate one)."""
    import jax
    from test_torch_parallel import CASES

    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp

    make, kw = CASES["varied"]
    args = make()
    ref = jax.vmap(lambda *a: jgicp.align(*a, jgicp.GICPSettings(**kw)))(*args)
    calls = _count_inner(monkeypatch)
    res = gicp.align_batch(*(torch.from_numpy(np.array(x)) for x in args), gicp.GICPSettings(**kw))
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-5)
    for f in ("iterations", "num_inliers", "converged"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    assert calls["inner"] == int(res.iterations.max()) > 0 and calls["split"] == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    return torch.device("cuda", 0)


# (B, N, with a batch axis): the shared-memory route at the bench cloud's
# 16,384 points, a count that is no multiple of P, streams off a 16-byte
# boundary (1,001 points: 12,012 and 1,001 bytes a stream), and the
# device-memory route at the CLI cloud's 65,536
GPU_CASES = [(1, 16384, False), (8, 16384, True), (8, 17000, True), (3, 1001, True),
             (1, 65536, False), (8, 65536, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,lead", GPU_CASES, ids=lambda v: str(v))
def test_inner_kernel_is_its_plain_version_on_the_card(B, N, lead):
    dev = _cuda()
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    lib = nn_cuda.build()["lm_trial"].lib
    assert lib.ddlo_lm_inner_layout() == gicp.LM_CLUSTER * 1000 + gicp.LM_THREADS
    assert (N <= lib.ddlo_lm_inner_shared_max_n()) == (N < 65536)
    for s in (S, S._replace(lm_max_iterations=3), S._replace(lm_max_iterations=0)):
        args = [x.to(dev) for x in inner_case(B, N, seed=B + N, lead=lead)]
        a, b = list(args), list(args)
        a[1], b[1] = args[1].clone(), args[1].clone()
        nn_cuda.LAUNCHES.clear()
        got = gicp.lm_inner(*a, s)
        want = gicp.lm_inner_plain(*b, s)
        torch.cuda.synchronize()
        assert nn_cuda.LAUNCHES["lm_inner"] == 1
        for f, x, y in zip(gicp.TrialState._fields, got, want):
            assert _bits(x) == _bits(y), (f, s.lm_max_iterations)
