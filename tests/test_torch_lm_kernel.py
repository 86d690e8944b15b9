"""GICP's lambda trial kernels (``csrc/lm_trial.cu``: ``ddlo_lm_propose``
and ``ddlo_lm_decide``, wrapped by ``ops/gicp.lm_propose`` /
``lm_decide``) through their plain versions, against the JAX package.

- ``lm_propose_plain`` against the JAX package's ``gicp.solve6_ldlt`` and
  ``se3.se3_exp`` on seeded systems: SPD and near-singular H, a pivot
  that the ``|d| < 1e-30`` guard replaces, the small-angle branch of
  ``so3_exp_quat``, d = 0, the GN step's zeroed streams, B = 1 and 8.
  Bars: delta within 1e-6; d within 1e-6 of its largest entry, and on
  the near-singular case (condition number up to ~1e4) within 1e-6 of
  ``b`` in the residual ``(H + lam I)(d - d_jax)``. The plain version is
  the card's arithmetic: each product and difference rounded once, where
  XLA on the CPU fuses the LDLT's ``v - p q`` into an FMA. The two differ
  by a few ulp, which the solve grows by the condition number: 1.8e-4
  relative on d at 1e4 (the residual stays at 1.6e-7 of b), so there the
  residual, which does not grow with it, holds d.
- ``lm_decide_plain`` against a numpy transcription of the JAX trial
  body (``gicp.py:360-392``): the same decision on every stream (accept,
  reject-and-grow, converge-on-reject, the 0/0 guard of an exact step
  d = 0), the pose and the final step copied bit for bit, lambda and nu
  within 1e-6 relative (the denominator's order differs), streams that
  are not active left untouched bit for bit, and a run of rejected
  trials that exhausts ``lm_max_iterations``.
- ``align`` and ``align_batch`` with the card's arithmetic (``gicp.TORCH``)
  on the host against the JAX package (its ``align`` and
  ``jax.vmap(gicp.align)``), at tests/test_torch_parallel.py's bars: an LM
  iteration's lambda loop is one ``lm_inner`` call and runs no split
  trial; a GN iteration runs ``lm_propose`` once.
- On the CPU the wrappers take the plain versions, never a CUDA build;
  other devices raise. The ``gpu`` cases hold the kernels to the plain
  versions bit for bit on the card (and a dense sweep of half-angles
  through ``sinf`` / ``cosf``); this module imports JAX only inside the
  CPU cases, so they run on a host without it:
  ``python -m pytest --noconftest tests/test_torch_lm_kernel.py -m gpu``.
"""

import functools

import numpy as np
import pytest
import torch

from torch_lm_cases import DECIDE_CASES, S, as_tensors, decide_batch, half_angle_sweep, propose_cases

from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build, gicp


@functools.lru_cache(maxsize=1)
def _jax_step():
    """The JAX package's solve and exponential, vmapped and jitted once."""
    import jax
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry_tpu.core import se3 as jse3
    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp

    def one(H, b, lam, z):
        d = jgicp.solve6_ldlt(H + lam * jnp.eye(6, dtype=H.dtype), -b)
        d = jnp.where(z, 0.0, d)
        return d, jse3.se3_exp(d)

    return jax.jit(jax.vmap(one))


def _jax_propose(H, b, lam, zero):
    z = np.zeros(len(lam), bool) if zero is None else zero
    d, delta = _jax_step()(H, b, lam, z)
    return np.asarray(d), np.asarray(delta)


@pytest.mark.parametrize("case", propose_cases(), ids=lambda c: c[0])
def test_propose_plain_matches_jax(case):
    name, H, b, lam, zero = case
    d, delta = gicp.lm_propose_plain(*as_tensors(H, b, lam, zero))
    jd, jdelta = _jax_propose(H, b, lam, zero)
    if name.startswith("near_singular"):
        A = H.astype(np.float64) + lam[:, None, None] * np.eye(6)
        r = np.einsum("bij,bj->bi", A, d.numpy().astype(np.float64) - jd)
        assert (np.abs(r) <= 1e-6 * np.abs(b).max(axis=1, keepdims=True)).all(), name
    else:
        assert (np.abs(d.numpy() - jd) <= 1e-6 * np.abs(jd).max(axis=1, keepdims=True)).all(), name
    np.testing.assert_allclose(delta.numpy(), jdelta, rtol=0, atol=1e-6, err_msg=name)
    if name.startswith("d_zero"):
        assert not d.numpy().any() and (delta.numpy() == np.eye(4, dtype=np.float32)).all()
    if name.startswith("gn_zero"):
        assert not d.numpy()[zero].any()


def _np_trial(st, d, b, y0, yi, delta, xi, s=S):
    """The JAX package's lm_inner body (gicp.py:360-392) in numpy f32,
    for one stream: st = (lam, nu, done, accepted, conv, x, delta_prev)."""
    f = np.float32
    lam, nu, done, accepted, conv, x, delta_prev = st
    denom = max(f(np.dot(d, lam * d - b)), f(1e-30))
    rho = f((y0 - yi) / denom)
    reject = bool(rho < 0)
    rd = np.abs(delta[:3, :3] - np.eye(3, dtype=f)) / f(s.rotation_epsilon)
    td = np.abs(delta[:3, 3]) / f(s.transformation_epsilon)
    conv_on_reject = reject and bool(max(rd.max(), td.max()) < 1.0)
    accept = not reject
    if accept:
        lam = f(lam * max(f(1.0 / 3.0), f(1.0) - (f(2.0) * rho - f(1.0)) ** 3))
    elif not conv_on_reject:
        lam = f(nu * lam)
    nu = f(2.0) * nu if reject and not conv_on_reject else nu
    new_done = accept or conv_on_reject
    return (lam, nu, new_done, accepted or accept, conv or conv_on_reject, xi if accept else x,
            delta if new_done else delta_prev)


def _clone(st):
    return gicp.TrialState(*(x.clone() for x in st))


def _bits(x):
    return x.numpy().tobytes()


@pytest.mark.parametrize("case", list(DECIDE_CASES))
def test_decide_plain_matches_the_jax_trial_body(case):
    ins, st, kinds = DECIDE_CASES[case]()
    before = _clone(st)
    gicp.lm_decide_plain(*ins, st, S)
    y0, yi, d, b, delta, xi = (x.numpy() for x in ins)
    for s_ in range(len(kinds)):
        if kinds[s_] == "frozen":
            for f in gicp.TrialState._fields[:-1]:
                assert _bits(getattr(st, f)[s_]) == _bits(getattr(before, f)[s_]), (kinds[s_], f)
            continue
        old = (before.lam[s_].numpy(), before.nu[s_].numpy(), bool(before.done[s_]),
               bool(before.accepted[s_]), bool(before.conv[s_]), before.x[s_].numpy(),
               before.delta_done[s_].numpy())
        lam, nu, done, acc, conv, x, dd = _np_trial(old, d[s_], b[s_], y0[s_], yi[s_], delta[s_], xi[s_])
        assert (bool(st.done[s_]), bool(st.accepted[s_]), bool(st.conv[s_])) == (done, acc, conv), kinds[s_]
        assert bool(st.act[s_]) == (not done)
        want = {"accept": (True, False), "grow": (False, False), "conv_reject": (True, True),
                "zero_step": (True, False), "boundary": (done, done)}[kinds[s_]]
        assert (done, conv) == want, kinds[s_]
        np.testing.assert_allclose(st.lam[s_].numpy(), lam, rtol=1e-6, err_msg=kinds[s_])
        np.testing.assert_allclose(st.nu[s_].numpy(), nu, rtol=1e-6, err_msg=kinds[s_])
        assert st.x[s_].numpy().tobytes() == x.tobytes() and st.delta_done[s_].numpy().tobytes() == dd.tobytes()
    assert int(st.j) == int(before.j) + 1
    if case == "convergence_boundary":  # both sides of the bar, on either test
        for half in np.split(st.conv.numpy(), 2):
            assert half.any() and not half.all()
    # the 0/0 guard: rho = 0 / 1e-30 = 0, an accepted step that doubles lambda
    z = kinds == "zero_step"
    np.testing.assert_array_equal(st.lam.numpy()[z], before.lam.numpy()[z] * 2)


def test_rejected_trials_exhaust_lm_max_iterations():
    """Every trial rejected and not converged: lambda and nu grow each
    time, nothing is done after lm_max_iterations trials (the loop's
    predicate stops there), as the numpy body gives it."""
    ins, st, kinds = decide_batch(4)
    grow = kinds == "grow"
    grow = torch.from_numpy(grow)
    st = gicp.TrialState(*(x[grow] if x.dim() else x.zero_() for x in st))
    ins = [x[grow] for x in ins]
    s = gicp.GICPSettings(lm_max_iterations=3)
    ref = [(st.lam[i].numpy().copy(), st.nu[i].numpy().copy(), False, bool(st.accepted[i]), False,
            st.x[i].numpy().copy(), st.delta_done[i].numpy().copy()) for i in range(int(grow.sum()))]
    while bool((st.j < s.lm_max_iterations) & st.act.any()):
        gicp.lm_decide_plain(*ins, st, s)
        ref = [_np_trial(r, *(x[i].numpy() for x in (ins[2], ins[3], ins[0], ins[1], ins[4], ins[5])), s)
               for i, r in enumerate(ref)]
    assert int(st.j) == 3 and not st.done.any() and st.act.all()
    np.testing.assert_allclose(st.lam.numpy(), [r[0] for r in ref], rtol=1e-6)
    np.testing.assert_array_equal(st.nu.numpy(), [r[1] for r in ref])


def _count_trials(monkeypatch):
    """Calls of the card arithmetic's trial functions, of the split
    trial's error re-evaluation and of the whole lambda loop
    (``lm_inner``, with the trials its streams ran)."""
    calls = {"propose": 0, "decide": 0, "error": 0, "inner": 0, "inner_trials": 0}
    for key, ns, name in (("propose", gicp.TORCH, "lm_propose"), ("decide", gicp.TORCH, "lm_decide"),
                          ("error", gicp, "_compute_error"), ("inner", gicp.TORCH, "lm_inner")):
        def wrap(*a, _fn=getattr(ns, name), _key=key, **k):
            calls[_key] += 1
            out = _fn(*a, **k)
            if _key == "inner":
                calls["inner_trials"] += int(out.j.sum())
            return out
        monkeypatch.setattr(ns, name, wrap)
    monkeypatch.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)
    return calls


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_card_arithmetic_align_matches_jax(optimizer, monkeypatch):
    """align on the card's arithmetic (the trial's plain versions) against
    the JAX package's align, on tests/test_torch_gicp_bits.py's inputs at
    its card bars (pose within 1e-6, the same counts)."""
    from test_torch_gicp_bits import _inputs

    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp

    T, src, sm, sc, tgt, tm, tc = _inputs(1024, 0 if optimizer == "lm" else 1)
    guess = np.eye(4, dtype=np.float32)
    ref = jgicp.align(src, sm, sc, tgt, tm, tc, guess, jgicp.GICPSettings(optimizer=optimizer))
    calls = _count_trials(monkeypatch)
    got = gicp.align(*as_tensors(src, sm, sc, tgt, tm, tc, guess), gicp.GICPSettings(optimizer=optimizer))
    assert int(got.iterations) == int(ref.iterations) and int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-6)
    if optimizer == "lm":
        # one lambda loop per LM iteration, each one lm_inner call running
        # at least one trial; no split trial
        assert calls["inner"] == int(got.iterations) > 0
        assert calls["inner_trials"] >= int(got.iterations)
        assert calls["propose"] == calls["decide"] == calls["error"] == 0
    else:
        assert calls["propose"] == int(got.iterations)
        assert calls["decide"] == calls["error"] == calls["inner"] == 0


def test_card_arithmetic_align_batch_matches_jax_vmap(monkeypatch):
    """align_batch on the card's arithmetic against jax.vmap(gicp.align),
    at tests/test_torch_parallel.py's bars (T within 1e-5, counts equal),
    on its "varied-lm-cap" case: streams that stop on the LM cap, frozen
    streams, a degenerate one."""
    import jax
    from test_torch_parallel import CASES

    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp

    make, kw = CASES["varied-lm-cap"]
    args = make()
    ref = jax.vmap(lambda *a: jgicp.align(*a, jgicp.GICPSettings(**kw)))(*args)
    calls = _count_trials(monkeypatch)
    res = gicp.align_batch(*as_tensors(*args), gicp.GICPSettings(**kw))
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-5)
    for f in ("iterations", "num_inliers", "converged"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    # one lm_inner call per pass of the batched loop (as many as the
    # longest stream's iterations), no split trial
    assert calls["inner"] == int(res.iterations.max()) > 0 and calls["inner_trials"] > 0
    assert calls["propose"] == calls["decide"] == calls["error"] == 0


def test_wrappers_take_the_plain_versions_on_cpu(monkeypatch):
    """CPU tensors never reach a CUDA build; other devices raise."""
    def no_build(*a, **k):
        raise AssertionError("a CUDA build was reached from CPU tensors")

    monkeypatch.setattr(_cuda_build, "load", no_build)
    monkeypatch.setattr(_cuda_build, "load_all", no_build)
    _, H, b, lam, _ = propose_cases()[0]
    d, delta = gicp.lm_propose(*as_tensors(H[0], b[0], lam[0]))
    pd, pdelta = gicp.lm_propose_plain(*as_tensors(H[0], b[0], lam[0]))
    assert d.shape == (6,) and delta.shape == (4, 4)
    assert _bits(d) == _bits(pd) and _bits(delta) == _bits(pdelta)
    ins, st, _ = decide_batch(5)
    st2 = _clone(st)
    gicp.lm_decide(*ins, st, S)
    gicp.lm_decide_plain(*ins, st2, S)
    assert all(_bits(a) == _bits(c) for a, c in zip(st, st2))
    meta = torch.empty((6, 6), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gicp.lm_propose(meta, meta[0], meta[0, 0])
    with pytest.raises(ValueError, match="no kernel"):
        gicp.lm_decide(meta[0, 0], *ins[1:], st, S)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    return torch.device("cuda", 0)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) if a.is_floating_point() else (a == b)
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


@pytest.mark.gpu
def test_propose_kernel_is_its_plain_version_on_the_card():
    dev = _cuda()
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    for name, *arrays in propose_cases():
        args = [None if a is None else a.to(dev) for a in as_tensors(*arrays)]
        nn_cuda.LAUNCHES.clear()
        d, delta = gicp.lm_propose(*args)
        pd, pdelta = gicp.lm_propose_plain(*args)
        assert nn_cuda.LAUNCHES["lm_propose"] == 1
        assert _same_bits(d, pd) and _same_bits(delta, pdelta), name


@pytest.mark.gpu
def test_propose_kernel_sweeps_the_half_angles_on_the_card():
    """The half-angles of ``torch_lm_cases.half_angle_sweep`` (2^20 streams):
    the kernel's sinf / cosf against torch.sin / torch.cos."""
    dev = _cuda()
    args = [x.to(dev) for x in half_angle_sweep()]
    n = args[0].shape[0]
    d, delta = gicp.lm_propose(*args)
    pd, pdelta = gicp.lm_propose_plain(*args)
    assert _same_bits(d, pd)
    differ = ~((delta.view(torch.int32) == pdelta.view(torch.int32)).reshape(n, 16).all(1))
    assert not bool(differ.any()), f"{int(differ.sum())} of {n} streams differ, at d {pd[differ][:5].cpu()}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECIDE_CASES))
def test_decide_kernel_is_its_plain_version_on_the_card(case):
    dev = _cuda()
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    ins, st, _ = DECIDE_CASES[case]()
    ins = [x.to(dev) for x in ins]
    st = gicp.TrialState(*(x.to(dev) for x in st))
    st2 = _clone(st)
    nn_cuda.LAUNCHES.clear()
    gicp.lm_decide(*ins, st, S)
    gicp.lm_decide_plain(*ins, st2, S)
    assert nn_cuda.LAUNCHES["lm_decide"] == 1
    for f, a, c in zip(gicp.TrialState._fields, st, st2):
        assert _same_bits(a, c), f
