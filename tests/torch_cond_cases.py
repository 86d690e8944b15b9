"""A grid of loop and branch tests (``core/control.Test``), numpy and
torch only: tests/test_torch_cond_test.py holds the test's plain
evaluation to a numpy evaluation and to the hand expressions it replaced
on them, and ``chip_smoke.py`` phase 3 holds the kernel
(``csrc/graph_cond.cu`` ``ddlo_set_cond``) to the plain evaluation on
them.

Each case is ``(name, count, flags, negated, differ)``: ``count`` an int
or None (the count at LIMIT - 1, LIMIT, LIMIT + 1), ``flags`` bool arrays
of n entries (0-d for n = 1), ``negated`` which of them the test negates,
``differ`` None or two int32 arrays of n entries with 0, 1 or all entries
differing."""

import itertools

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import control

LIMIT = 5
COUNTS = (None, LIMIT - 1, LIMIT, LIMIT + 1)
SIZES = (1, 3, 64)


def _flag_values(rng, n, nflags):
    """Every combination for n = 1; for larger n all false, all true, one
    entry true in every flag, and three random patterns."""
    if nflags == 0:
        return [()]
    if n == 1:
        return [tuple(np.array(v) for v in vals) for vals in itertools.product((False, True), repeat=nflags)]
    out = [tuple(np.zeros(n, bool) for _ in range(nflags)), tuple(np.ones(n, bool) for _ in range(nflags))]
    one = np.zeros(n, bool)
    one[rng.integers(n)] = True
    out.append(tuple(one.copy() for _ in range(nflags)))
    for _ in range(3):
        out.append(tuple(rng.random(n) < 0.6 for _ in range(nflags)))
    return out


def grid(seed=0):
    """Every case: each count, each size, 0-3 flags with every negation
    pattern, and the != form."""
    rng = np.random.default_rng(seed)
    cases = []
    for n in SIZES:
        for nflags in range(4):
            for neg in itertools.product((False, True), repeat=nflags):
                for vi, vals in enumerate(_flag_values(rng, n, nflags)):
                    for count in COUNTS:
                        if nflags == 0 and count is None:
                            continue  # no tensor: no device to decide on
                        name = f"n{n}_flags{nflags}_neg{''.join('1' if x else '0' for x in neg)}_v{vi}_count{count}"
                        cases.append((name, count, vals, neg, None))
        for ndiff in (0, 1, n):
            a = rng.integers(-3, 3, n).astype(np.int32)
            b = a.copy()
            b[rng.permutation(n)[:ndiff]] += 1
            for count in COUNTS:
                cases.append((f"n{n}_differ{ndiff}_count{count}", count, (), (), (a, b)))
    return cases


def expected(count, flags, negated, differ) -> bool:
    """The test in numpy: (count < LIMIT if given) and any entry's term."""
    if differ is not None:
        term = differ[0] != differ[1]
    else:
        term = np.ones(np.shape(flags[0]) if flags else (), bool)
        for f, neg in zip(flags, negated):
            term = term & (~f if neg else f)
    return bool(np.any(term)) and (count is None or count < LIMIT)


def to_test(count, flags, negated, differ, device="cpu") -> control.Test:
    """The case as a ``control.Test`` on ``device``."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return control.Test(
        count=None if count is None else t(count, torch.int32),
        limit=LIMIT,
        all_of=tuple(t(f, torch.bool) for f, neg in zip(flags, negated) if not neg),
        none_of=tuple(t(f, torch.bool) for f, neg in zip(flags, negated) if neg),
        differ=None if differ is None else (t(differ[0], torch.int32), t(differ[1], torch.int32)),
    )


def ccl_sized(seed=0, n=64 * 2048):
    """CCL's test at the bench's 64 x 2,048 labels: (name, a, b) pairs with
    no, one (the last entry) and many entries differing."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 30, n).astype(np.int32)
    last = a.copy()
    last[-1] += 1
    many = a.copy()
    many[rng.random(n) < 0.01] += 1
    return [("equal", a, a.copy()), ("last_differs", a, last), ("one_percent_differ", a, many)]
