"""The loop and branch test of ``core/control.py`` (``control.Test``,
evaluated on the card by one launch of ``csrc/graph_cond.cu``
``ddlo_set_cond``).

On the CPU: the test's plain evaluation (``Test.plain``, what the eager
driver reads) equals a numpy evaluation on the grid of
``tests/torch_cond_cases.py`` (the count below, at and above its limit,
every flag and negation combination at n = 1, 3 and 64, the int32 !=
form with 0, 1 and all entries differing) and the hand expressions it
replaced at the call sites (GICP's loops, ``align_batch``'s, CCL's); and
``control.while_loop`` / ``control.cond`` driven by such tests match
``jax.lax.while_loop`` / ``lax.cond`` with the JAX-form ``cond_fun`` on
numpy-seeded carries. The ``gpu`` cases hold the kernel's output byte to
the plain evaluation on the same grid, an IF / ELSE pair set in one
launch, and CCL's 131,072-entry test twice in a row; they import no JAX:
``python -m pytest --noconftest tests/test_torch_cond_test.py -m gpu``.
"""

import numpy as np
import pytest
import torch

import torch_cond_cases as cc

from dynamic_direct_lidar_odometry_tpu_torch.core import control

GRID = cc.grid()


@pytest.mark.parametrize("count", cc.COUNTS)
@pytest.mark.parametrize("n", cc.SIZES)
def test_plain_matches_numpy_on_the_grid(n, count):
    cases = [c for c in GRID if c[0].startswith(f"n{n}_") and c[1] == count]
    assert len(cases) == (84 if count is None else 85) + 3
    for name, *case in cases:
        got = cc.to_test(*case).plain()
        assert got.dtype == torch.bool and got.shape == ()
        assert bool(got) == cc.expected(*case), name


def _bools(*shape):
    """Every bool pattern of the given shape (a few entries)."""
    size = int(np.prod(shape, dtype=int))
    for bits in range(1 << size):
        yield torch.tensor([(bits >> k) & 1 == 1 for k in range(size)]).reshape(shape)


# each replaced call-site expression (left) and its Test (right), over
# counts at the limit -1 / 0 / +1 and every flag pattern
REPLACED = {
    "gicp_align_running": (
        lambda c, f, g: (c < cc.LIMIT) & ~f & ~g,
        lambda c, f, g: control.Test(c, cc.LIMIT, none_of=(f, g)), ()),
    "gicp_align_trial_more": (
        lambda c, f, g: (c < cc.LIMIT) & ~f & ~g,
        lambda c, f, g: control.Test(c, cc.LIMIT, none_of=(f, g)), ()),
    "align_batch_running": (
        lambda c, f, g: (c < cc.LIMIT) & (~f & ~g).any(),
        lambda c, f, g: control.Test(c, cc.LIMIT, none_of=(f, g)), (3,)),
    "align_batch_trial_more": (
        lambda c, f, g: (c < cc.LIMIT) & f.any(),
        lambda c, f, g: control.Test(c, cc.LIMIT, all_of=(f,)), (4,)),
}


@pytest.mark.parametrize("site", sorted(REPLACED))
def test_plain_equals_the_replaced_expression(site):
    hand, test, shape = REPLACED[site]
    for count in cc.COUNTS[1:]:
        c = torch.tensor(count, dtype=torch.int32)
        for f in _bools(*shape):
            for g in _bools(*shape):
                assert torch.equal(test(c, f, g).plain(), hand(c, f, g)), (site, count, f, g)


def test_plain_equals_ccls_expression():
    rng = np.random.default_rng(3)
    for count in cc.COUNTS[1:]:
        it = torch.tensor(count, dtype=torch.int32)
        L = torch.as_tensor(rng.integers(0, 9, (8, 16)).astype(np.int32))
        for prev in (L.clone(), L + 1, torch.where(torch.arange(128).reshape(8, 16) == 77, L - 1, L)):
            got = control.Test(it, cc.LIMIT, differ=(L, prev)).plain()
            assert torch.equal(got, (it < cc.LIMIT) & torch.any(L != prev))


def test_tensor_predicates_are_one_flag_tests():
    for v in (False, True):
        t = control._as_test(torch.tensor([v]))
        assert t.all_of[0].shape == () and bool(t.plain()) is v


def test_set_cond_refuses_other_forms_before_building(monkeypatch):
    """Wrong dtypes, sizes or combinations raise before any build."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build

    def no_build(*a, **k):
        raise AssertionError("a CUDA build was reached")

    monkeypatch.setattr(_cuda_build, "load", no_build)
    monkeypatch.setattr(_cuda_build, "load_all", no_build)
    b1, b3, i3 = torch.ones((), dtype=torch.bool), torch.ones(3, dtype=torch.bool), torch.ones(3, dtype=torch.int32)
    for bad in (control.Test(all_of=(i3,)), control.Test(all_of=(b1, b3)),
                control.Test(all_of=(b1, b1), none_of=(b1, b1)), control.Test(differ=(b3, b3)),
                control.Test(all_of=(b3,), differ=(i3, i3)), control.Test(count=torch.ones(()), all_of=(b1,)),
                control.Test()):
        with pytest.raises(ValueError):
            control.set_cond(bad)


def _seeded(seed, size):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size).astype(np.float32)


# (turn bound, limit on x): no turn, an exit on the data, the bound
LOOPS = {"zero_turns": (0, 1e9), "early_exit": (40, 30.0), "bound_reached": (6, 1e9)}


@pytest.mark.parametrize("case", sorted(LOOPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_flag_test_loop_matches_lax(case, seed):
    """GICP's shape: (it < bound) & ~converged & ~failed, per stream any."""
    import jax
    import jax.numpy as jnp

    bound, limit = LOOPS[case]
    x0 = _seeded(seed, (3, 4))

    def jbody(c):
        x, it, conv, failed = c
        run = ~conv & ~failed
        x = jnp.where(run[:, None], x * jnp.float32(1.5), x)
        return x, it + 1, conv | (jnp.max(x, axis=1) > limit), failed

    failed0 = np.array([False, False, seed == 1])
    jx, jit, jconv, _ = jax.lax.while_loop(
        lambda c: (c[1] < bound) & jnp.any(~c[2] & ~c[3]), jbody,
        (jnp.asarray(x0), jnp.int32(0), jnp.zeros(3, bool), jnp.asarray(failed0)))

    control.PREDICATE_READS.clear()
    x, it = torch.from_numpy(x0.copy()), torch.zeros((), dtype=torch.int32)
    conv, failed = torch.zeros(3, dtype=torch.bool), torch.from_numpy(failed0.copy())

    def body(x, it, conv, failed):
        run = ~conv & ~failed
        x.copy_(torch.where(run[:, None], x * 1.5, x))
        it.add_(1)
        conv.logical_or_(torch.amax(x, dim=1) > limit)

    control.while_loop(lambda x, it, conv, failed: control.Test(it, bound, none_of=(conv, failed)),
                       body, (x, it, conv, failed))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert int(it) == int(jit) and control.PREDICATE_READS["while"] == int(jit) + 1
    turns = {"zero_turns": int(jit) == 0, "early_exit": 0 < int(jit) < bound, "bound_reached": int(jit) == bound}
    assert turns[case]


@pytest.mark.parametrize("max_iters", [0, 2, 64])
def test_differ_test_loop_matches_lax(max_iters):
    """CCL's shape: sweep while (it < max_iters) & any(L != prev)."""
    import jax
    import jax.numpy as jnp

    L0 = np.random.default_rng(max_iters).permutation(48).astype(np.int32).reshape(4, 12)

    def jbody(c):
        L, prev, it = c
        return jnp.minimum(L, jnp.minimum(jnp.roll(L, 1, 0), jnp.roll(L, 1, 1))), L, it + 1

    jL, _, jit = jax.lax.while_loop(lambda c: (c[2] < max_iters) & jnp.any(c[0] != c[1]), jbody,
                                    (jnp.asarray(L0), jnp.asarray(L0 + 1), jnp.int32(0)))
    control.PREDICATE_READS.clear()
    L, prev, it = torch.from_numpy(L0.copy()), torch.from_numpy(L0 + 1), torch.zeros((), dtype=torch.int32)

    def sweep(L, prev, it):
        prev.copy_(L)
        L.copy_(torch.minimum(L, torch.minimum(torch.roll(L, 1, 0), torch.roll(L, 1, 1))))
        it.add_(1)

    control.while_loop(lambda L, prev, it: control.Test(it, max_iters, differ=(L, prev)), sweep, (L, prev, it))
    np.testing.assert_array_equal(L.numpy(), np.asarray(jL))
    assert int(it) == int(jit) and control.PREDICATE_READS["while"] == int(jit) + 1
    if max_iters == 64:
        assert 0 < int(jit) < 64 and bool((L == 0).all())


@pytest.mark.parametrize("count", cc.COUNTS[1:])
@pytest.mark.parametrize("flags", [(False, False), (False, True), (True, False), (True, True)])
def test_cond_with_a_test_matches_lax(count, flags):
    import jax
    import jax.numpy as jnp

    x0 = _seeded(9, 5)
    f, g = (np.array(v) for v in flags)
    jx = jax.lax.cond((jnp.int32(count) < cc.LIMIT) & jnp.asarray(f) & ~jnp.asarray(g),
                      lambda v: v * jnp.float32(2.0), lambda v: v - jnp.float32(1.0), jnp.asarray(x0))
    x = torch.from_numpy(x0.copy())
    test = control.Test(torch.tensor(count, dtype=torch.int32), cc.LIMIT,
                        all_of=(torch.tensor(f),), none_of=(torch.tensor(g),))
    control.cond(test, lambda x: x.mul_(2.0), lambda x: x.sub_(1.0), (x,))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_grid():
    dev = _card()
    out = torch.zeros(len(GRID), dtype=torch.bool, device=dev)
    plain = []
    for k, (name, *case) in enumerate(GRID):
        test = cc.to_test(*case, device=dev)
        control.set_cond(test, out=out[k], scratch=control.scratch_for(test))
        plain.append(test.plain())
    want = torch.stack(plain).cpu()
    got = out.cpu()
    assert torch.equal(got, want), [GRID[k][0] for k in torch.nonzero(got != want).reshape(-1).tolist()]
    assert torch.equal(want, torch.tensor([cc.expected(*c) for _, *c in GRID]))


@pytest.mark.gpu
def test_kernel_sets_an_if_else_pair_in_one_launch():
    """A captured IF / ELSE pair on a Test: one set_cond per replay."""
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

    dev = _card()

    def fn(x, c, f):
        y = x.clone()
        control.cond(control.Test(c, cc.LIMIT, all_of=(f,)), lambda y: y.mul_(2.0), lambda y: y.sub_(1.0), (y,))
        return y

    x = torch.arange(8, dtype=torch.float32, device=dev)
    g = None
    for count in cc.COUNTS[1:]:
        for fv in (False, True):
            c = torch.tensor(count, dtype=torch.int32, device=dev)
            f = torch.tensor(fv, device=dev)
            g = g or control.Graph(fn, (x, c, f))
            with profiling.device_counts(dev) as counts:
                got = g(x, c, f)
            want = x * 2.0 if (count < cc.LIMIT and fv) else x - 1.0
            assert torch.equal(got, want) and counts.get("set_cond", 0) == 1


@pytest.mark.gpu
def test_kernel_ccl_sized_twice():
    """CCL's test over 131,072 int32 pairs: a grid of blocks whose last
    block decides and resets its scratch, so a second launch decides
    alike."""
    dev = _card()
    for name, a, b in cc.ccl_sized():
        for count in cc.COUNTS:
            test = cc.to_test(count, (), (), (a, b), device=dev)
            scratch = control.scratch_for(test)
            assert scratch is not None
            outs = torch.zeros(2, dtype=torch.bool, device=dev)
            for r in range(2):
                control.set_cond(test, out=outs[r], scratch=scratch)
            assert outs.tolist() == [cc.expected(count, (), (), (a, b))] * 2, (name, count)
            assert scratch.tolist() == [0]
