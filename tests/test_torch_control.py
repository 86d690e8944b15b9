"""core/control.py (the port's lax.while_loop / lax.cond) against
jax.lax on numpy-seeded carries: every output EQUAL. The eager driver
(the CPU) runs the same body code that a graph captures, and reads only
the predicate, once per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu_torch.core import control


def _no_host_reads_but_predicates(monkeypatch):
    """Every Tensor.__bool__ outside control.read_predicate raises."""
    real = torch.Tensor.__bool__
    inside = []

    def guarded(self):
        if not inside:
            raise AssertionError("a host read outside control.read_predicate")
        return real(self)

    def reading(pred, kind="while"):
        inside.append(1)
        try:
            control.PREDICATE_READS[kind] += 1
            return real(pred)
        finally:
            inside.pop()

    monkeypatch.setattr(torch.Tensor, "__bool__", guarded)
    monkeypatch.setattr(control, "read_predicate", reading)


def _seeded(seed, size=16):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size).astype(np.float32)


# (turn bound, limit on max(x)): 0 turns, an early exit on the data, the
# bound reached; single f32 operations, so XLA contracts none into an FMA
CASES = {"zero_turns": (0, 1e9), "early_exit": (50, 40.0), "bound_reached": (7, 1e9)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_while_loop_matches_lax(case, seed, monkeypatch):
    bound, limit = CASES[case]
    x0 = _seeded(seed)

    def jbody(c):
        x, i = c
        return x * jnp.float32(1.5), i + 1

    jx, ji = jax.lax.while_loop(
        lambda c: (c[1] < bound) & (jnp.max(c[0]) < limit), jbody, (jnp.asarray(x0), jnp.int32(0))
    )

    _no_host_reads_but_predicates(monkeypatch)
    control.PREDICATE_READS.clear()
    x, i = t(x0), torch.zeros((), dtype=torch.int32)

    def body(x, i):
        x.copy_(x * 1.5)
        i.add_(1)

    out = control.while_loop(lambda x, i: (i < bound) & (torch.max(x) < limit), body, (x, i))
    assert out[0] is x and out[1] is i  # the carry, updated in place
    np.testing.assert_array_equal(n(x), np.asarray(jx))
    assert int(n(i)) == int(ji)
    assert control.PREDICATE_READS["while"] == int(ji) + 1
    if case == "zero_turns":
        assert int(ji) == 0
    elif case == "early_exit":
        assert 0 < int(ji) < bound
    else:
        assert int(ji) == bound


@pytest.mark.parametrize("seed", [0, 3])
def test_nested_while_and_cond_match_lax(seed, monkeypatch):
    """An outer loop whose body runs an inner loop (i + 1 turns) and a
    branch on the data, as the LM's iteration and lambda loops do."""
    x0 = _seeded(seed, 8)

    def jinner(c):
        x, j = c
        return x * jnp.float32(1.25), j + 1

    def jouter(c):
        x, i, tot = c
        x, j = jax.lax.while_loop(lambda d: d[1] < i + 1, jinner, (x, jnp.int32(0)))
        x = jax.lax.cond(x[0] > jnp.float32(1.5), lambda v: v - jnp.float32(2.0),
                         lambda v: v * jnp.float32(3.0), x)
        return x, i + 1, tot + j

    jx, ji, jtot = jax.lax.while_loop(lambda c: c[1] < 4, jouter,
                                      (jnp.asarray(x0), jnp.int32(0), jnp.int32(0)))

    _no_host_reads_but_predicates(monkeypatch)
    control.PREDICATE_READS.clear()
    x, i, tot = t(x0), torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)

    def outer(x, i, tot):
        j = torch.zeros((), dtype=torch.int32)

        def inner(x, j):
            x.mul_(1.25)
            j.add_(1)

        control.while_loop(lambda x, j: j < i + 1, inner, (x, j))
        control.cond(x[0] > 1.5, lambda x: x.sub_(2.0), lambda x: x.mul_(3.0), (x,))
        i.add_(1)
        tot.add_(j)

    control.while_loop(lambda x, i, tot: i < 4, outer, (x, i, tot))
    np.testing.assert_array_equal(n(x), np.asarray(jx))
    assert (int(n(i)), int(n(tot))) == (int(ji), int(jtot)) == (4, 10)
    # 5 outer tests, 4 inner loops of i + 2 tests, 4 branches
    assert dict(control.PREDICATE_READS) == {"while": 5 + 14, "cond": 4}


@pytest.mark.parametrize("pred", [True, False])
def test_cond_matches_lax(pred, monkeypatch):
    x0 = _seeded(5, 6)
    jx = jax.lax.cond(jnp.bool_(pred), lambda v: v * jnp.float32(2.0), lambda v: v - jnp.float32(1.0),
                      jnp.asarray(x0))
    _no_host_reads_but_predicates(monkeypatch)
    x = t(x0)
    control.cond(torch.tensor(pred), lambda x: x.mul_(2.0), lambda x: x.sub_(1.0), (x,))
    np.testing.assert_array_equal(n(x), np.asarray(jx))
    y = t(x0)  # no false branch: the carry is left as it was
    control.cond(torch.tensor(pred), lambda y: y.mul_(2.0), None, (y,))
    np.testing.assert_array_equal(n(y), x0 * 2 if pred else x0)


def test_cpu_tensors_take_the_eager_driver():
    assert control._active(torch.zeros((), dtype=torch.bool)) is None


@pytest.mark.gpu
def test_captured_loops_match_eager_on_the_card():
    """The same nested loop and branch captured into a graph (WHILE and IF
    nodes) and replayed on several inputs: equal to the eager driver, and
    no synchronization during a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)

    def fn(x0, m):
        x, i, tot = x0.clone(), torch.zeros((), dtype=torch.int32, device=dev), \
            torch.zeros((), dtype=torch.int32, device=dev)

        def outer(x, i, tot):
            j = torch.zeros((), dtype=torch.int32, device=dev)

            def inner(x, j):
                x.copy_(x * 0.5 + 1.0)
                j.add_(1)

            control.while_loop(lambda x, j: j < m + i, inner, (x, j))
            control.cond(x[0] > 1.5, lambda x: x.sub_(2.0), lambda x: x.mul_(3.0), (x,))
            i.add_(1)
            tot.add_(j)

        control.while_loop(lambda x, i, tot: i < 4, outer, (x, i, tot))
        return x, tot

    x0 = torch.as_tensor(_seeded(7, 64), device=dev)
    g = None
    for m in (0, 2, 5):
        mt = torch.full((), m, dtype=torch.int32, device=dev)
        ref = fn(x0, mt)
        g = g or control.Graph(fn, (x0, mt))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = g(x0, mt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.gpu
def test_allocations_after_a_capture_stay_out_of_its_pool():
    """The capture routes every allocation of its thread to the graph's
    pool through torch's private entry points; after it, an ordinary
    allocation on the same thread comes from elsewhere, and its contents
    survive replays that write the pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)

    def fn(x):
        y = x * 2.0 + 1.0
        i = torch.zeros((), dtype=torch.int32, device=dev)

        def body(y, i):
            y.copy_(torch.cumsum(y, 0) * 1e-3)
            i.add_(1)

        control.while_loop(lambda y, i: i < 3, body, (y, i))
        return y - x

    x = torch.as_tensor(_seeded(3, 1 << 16), device=dev)
    g = control.Graph(fn, (x,))
    big = torch.full((1 << 16,), 7.0, device=dev)
    small = torch.full((8,), 5.0, device=dev)
    assert not control.in_pool(big, g.pool) and not control.in_pool(small, g.pool)
    for k in range(3):
        g(x + float(k))
    torch.cuda.synchronize()
    assert bool((big == 7.0).all()) and bool((small == 5.0).all())
