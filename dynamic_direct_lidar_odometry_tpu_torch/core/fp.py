"""An f32 fused multiply-add with one rounding, from eager PyTorch ops.

XLA's CPU code generator contracts a multiply that feeds an add into one
fused multiply-add, and the port copies those contractions wherever the
JAX package's bits reach an output. PyTorch has no fused f32
multiply-add, so :func:`fma32` builds one: the product of two f32 is
exact in f64; the f64 sum ``p + c`` is then rounded to odd (its exact
error from TwoSum; where the error is not zero and the last bit is even,
the sum steps one ulp toward the error), and that sum is rounded to f32
once. Rounding to odd with 53 >= 24 + 2 bits makes the second rounding
correct (Boldo & Melquiond, "Emulation of FMA and correctly rounded
sums: proved algorithms using rounding to odd", IEEE TC 2008).

Plain f64 rounding of the sum, then f32, rounds twice: when the f64 sum
lands on an f32 midpoint that the exact sum does not, round-half-even
can go the wrong way (a = b = 1 + 2^-12, c = 2^-80 gives 0x1.002p+0,
where the fused result is 0x1.002002p+0).

Denormals are kept: callers that copy XLA's flush do it after the call.
"""

from __future__ import annotations

import torch


def odd_sum(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p + c`` of two f64 tensors (broadcast), rounded to odd: the f64
    nearest sum, moved one ulp toward the exact sum where it is inexact
    and its last bit is even. Inf and NaN pass through as the f64 sum."""
    s = p + c
    pp = s - c
    e = (p - pp) + (c - (s - pp))  # TwoSum: s + e == p + c exactly
    bits = s.view(torch.int64)
    # inexact: truncate toward zero (one ulp back where s overshot the exact
    # sum), then set the last bit
    back = (e > 0) != (s > 0)
    odd = (bits - back.long()) | 1
    return torch.where((e != 0) & torch.isfinite(e), odd, bits).view(torch.float64)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, for tensors (broadcast) that
    hold f32 values in any float dtype; returns f32, denormals kept."""
    p = a.double() * b.double()  # exact
    return odd_sum(p, c.double()).float()
