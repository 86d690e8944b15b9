"""The port's f32 fused multiply-add emulation rounds once, as XLA's FMA.

``core.fp.fma32`` (torch) and its numpy twin ``ops.gicp_xla.fma32`` are
held to an exact rational oracle (``fractions``) and to the jitted JAX
``a * b + c`` on the CPU, which XLA contracts into one FMA, on products
that fall exactly on an f32 midpoint with an addend far below the f64
ulp: there the f64 sum rounds back to the midpoint, and rounding that to
f32 (half to even) goes the wrong way whenever the even neighbor lies
on the other side of the exact sum. The emulation the port used before
(f64 product plus addend, rounded to f64, then to f32) fails on those
cases, and the tests show it.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic_direct_lidar_odometry_tpu_torch.core import fp
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp_xla

_JAX_FMA = jax.jit(lambda a, b, c: a * b + c)


def _oracle(a, b, c) -> np.ndarray:
    """Round the exact a * b + c to f32, half to even (finite results)."""
    out = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
        out.append(min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.int32)) & 1)))
    return np.array(out, np.float32)


def _double_rounded(a, b, c) -> np.ndarray:
    """The port's earlier emulation: f64 product plus addend, then f32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _all_ways(a, b, c):
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    return dict(
        torch=fp.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy(),
        numpy=gicp_xla.fma32(a, b, c),
        jax=np.asarray(_JAX_FMA(a, b, c)),
        oracle=_oracle(a, b, c),
    )


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


T = 1.0 + 2.0**-12  # T * T = 1 + 2^-11 + 2^-24: an f32 midpoint


@pytest.mark.parametrize("sa, sb, sc", [(sa, sb, sc) for sa in (1, -1) for sb in (1, -1) for sc in (1, -1)])
def test_midpoint_product_with_a_tiny_addend(sa, sb, sc):
    """a = +-(1 + 2^-12), b = +-(1 + 2^-12), c = +-2^-80: the fused
    result leaves the midpoint in c's direction."""
    a, b, c = [sa * T], [sb * T], [sc * 2.0**-80]
    got = _all_ways(a, b, c)
    for name in ("torch", "numpy", "jax"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(got["oracle"]), err_msg=name)
    away = (sa * sb > 0) == (sc > 0)  # c pushes the sum away from zero
    assert abs(float(got["oracle"][0])) == float.fromhex("0x1.002002p+0" if away else "0x1.002p+0")
    # the double rounding lands on the even neighbor, 0x1.002p+0, either way
    wrong = _double_rounded(np.float32(a), np.float32(b), np.float32(c))
    assert abs(float(wrong[0])) == float.fromhex("0x1.002p+0")
    assert (_bits(wrong) != _bits(got["oracle"])).any() == away


def test_midpoint_case_and_its_mirror():
    """0x1.002p+0 from the double rounding, 0x1.002002p+0 fused; and the
    mirror, a product just above the odd neighbor's midpoint."""
    got = _all_ways([T], [T], [2.0**-80])
    assert float(got["torch"][0]).hex() == "0x1.0020020000000p+0"
    assert float(_double_rounded(np.float32([T]), np.float32([T]), np.float32([2.0**-80]))[0]).hex() \
        == "0x1.0020000000000p+0"
    # (1 + 2^-12)(1 + 3 2^-12) = 1 + 4 2^-12 + 3 2^-24: the midpoint between
    # an odd neighbor below and an even one above, with c just below
    a, b = 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12
    got = _all_ways([a], [b], [-(2.0**-80)])
    for name in ("torch", "numpy", "jax"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(got["oracle"]), err_msg=name)
    assert _bits(got["oracle"])[0] & 1 == 1
    wrong = _double_rounded(np.float32([a]), np.float32([b]), np.float32([-(2.0**-80)]))
    assert (_bits(wrong) != _bits(got["oracle"])).all()


@st.composite
def _midpoint_cases(draw):
    """64 products on f32 midpoints, each with an addend below the f64
    ulp: a = +-(1 + i 2^-12) 2^ea, b = +-(1 + j 2^-12) 2^eb with i j odd
    (then a b sits on an f32 midpoint when a b < 2 (times 2^(ea+eb))), or
    i j = 2 mod 4 (when a b >= 2), and c = +-2^(ea + eb - k), a normal
    f32 (XLA flushes denormals)."""
    a, b, c = [], [], []
    while len(a) < 64:
        i = draw(st.integers(1, 2**12 - 1))
        j = draw(st.integers(1, 2**12 - 1))
        p = (1 + i * 2.0**-12) * (1 + j * 2.0**-12)
        if not ((p < 2 and (i * j) % 2 == 1) or (p >= 2 and (i * j) % 4 == 2)):
            continue
        ea, eb = draw(st.integers(-15, 15)), draw(st.integers(-15, 15))
        k = draw(st.integers(56, 90))
        sa, sb, sc = (draw(st.sampled_from([1.0, -1.0])) for _ in range(3))
        a.append(sa * (1 + i * 2.0**-12) * 2.0**ea)
        b.append(sb * (1 + j * 2.0**-12) * 2.0**eb)
        c.append(sc * 2.0 ** (ea + eb - k))
    return a, b, c


@settings(max_examples=40, deadline=None, derandomize=True)
@given(_midpoint_cases())
def test_hypothesis_midpoints_round_once(case):
    got = _all_ways(*case)
    for name in ("torch", "numpy", "jax"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(got["oracle"]), err_msg=name)


def test_double_rounding_fails_on_the_midpoint_cases():
    """On a fixed draw of the midpoint construction the earlier emulation
    is wrong on the cases whose addend points away from the even
    neighbor; the repaired one on none."""
    rng = np.random.default_rng(3)
    i, j = rng.integers(1, 2**12, 4096), rng.integers(1, 2**12, 4096)
    keep = (i * j) % 2 == 1
    a = (1 + i[keep] * 2.0**-12).astype(np.float32)
    b = (1 + j[keep] * 2.0**-12).astype(np.float32)
    p = a.astype(np.float64) * b
    a, b = a[p < 2], b[p < 2]
    c = np.where(rng.random(len(a)) < 0.5, 1, -1).astype(np.float32) * np.float32(2.0**-70)
    got = _all_ways(a, b, c)
    wrong = (_bits(_double_rounded(a, b, c)) != _bits(got["oracle"])).sum()
    assert 0.3 * len(a) < wrong < 0.7 * len(a)  # half of them: the even side is a coin toss
    for name in ("torch", "numpy", "jax"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(got["oracle"]), err_msg=name)


def test_odd_sum_passes_inf_nan_and_exact_sums():
    p = torch.tensor([1.0, float("inf"), float("nan"), 0.5, -0.0, 3.0], dtype=torch.float64)
    c = torch.tensor([2.0**-60, 1.0, 1.0, 0.25, -0.0, -3.0], dtype=torch.float64)
    got = fp.odd_sum(p, c)
    assert got[0].item() == np.nextafter(1.0, 2.0)  # inexact, 1.0 is even: to odd, upward
    assert got[1].item() == float("inf") and np.isnan(got[2].item())
    assert got[3].item() == 0.75 and str(got[4].item()) == "-0.0" and str(got[5].item()) == "0.0"
    np.testing.assert_array_equal(gicp_xla.odd_sum(p.numpy(), c.numpy()), got.numpy())


def _tie_chain(K=40, n=64, seed=7):
    """(K, n) factors of FMA chains that meet f32 midpoints: a tiny first
    term (+-2^-80), then the midpoint product (1 + 2^-12)^2 (its f64 sum
    lands on the midpoint, inexactly), then products with 25-bit sums
    (exact midpoints) and more tiny terms, in random order."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((K, n)) < 0.5, np.float32(T), np.float32(1.0)).astype(np.float32)
    b = np.where(rng.random((K, n)) < 0.5, np.float32(T), np.float32(2.0**-24)).astype(np.float32)
    a[rng.random((K, n)) < 0.2] = np.float32(2.0**-70)
    a[0] = np.where(rng.random(n) < 0.5, 1, -1).astype(np.float32) * np.float32(2.0**-40)
    b[0] = np.float32(2.0**-40)
    a[1], b[1] = np.float32(T), np.float32(T)
    return a, b


def test_numpy_fma_chain_rounds_each_step_once():
    """``gicp_xla.fma_chain`` (plain f64 sums, the steps that may misround
    redone with the odd sum) equals a chain of one-rounding FMAs, step by
    step, on a chain where the plain f64 sums do misround."""
    a, b = _tie_chain()
    want = np.zeros(a.shape[1], np.float32)
    plain = want.copy()
    for k in range(a.shape[0]):
        want = gicp_xla.fma32(a[k], b[k], want)
        plain = _double_rounded(a[k], b[k], plain)
    want, plain = gicp_xla._r(want), gicp_xla._r(plain)
    assert (_bits(plain) != _bits(want)).any()  # the chain does meet misrounding sums
    np.testing.assert_array_equal(_bits(gicp_xla.fma_chain(a, b)), _bits(want))


def test_misround_check_flags_inexact_midpoints_only():
    """The chain's check: an exact sum on an f32 midpoint (two f32 values
    whose sum needs 25 bits) is not flagged; the same midpoint reached by
    an inexact sum is."""
    p = np.array([1.0, T * T, T * T, 0.5], np.float64)
    c = np.array([2.0**-24, 2.0**-80, 0.0, 0.25], np.float64)
    s = p + c
    np.testing.assert_array_equal(gicp_xla._misrounds(s, p, c), [False, True, False, False])
