"""The card's published peaks and the least time each hand-written kernel
of the port could take, as functions of its shapes and live counts
(copied from ``chip_smoke.py``'s bound arithmetic).

No per-layer metric reads these yet: a kernel's roofline share needs each
call's work (live rows, candidate pairs, trials), which the program does
not count per call. Once it does, ``<kernel>_roofline`` is
``100 * bound_ms(...) / kernel_ms``, against the peaks below, stated with
the card's power limit (the peaks assume 700 W).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores, counting a fused multiply-add as two
operations; 34 TFLOP/s in float64 likewise; 3.35 TB/s of HBM3. The port
builds its kernels with ``--fmad=false``, so no multiply-add fuses and
each float32 operation is one issue: the issue rate is half the
published FLOP/s.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # published; an FMA counts as 2
PEAK_FP64_FLOPS = 34e12  # published; an FMA counts as 2
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_POWER_W = 700.0  # the limit the peaks assume

FP32_ISSUE_PER_S = PEAK_FP32_FLOPS / 2  # one unfused operation an issue
FP64_ISSUE_PER_S = PEAK_FP64_FLOPS / 2

# 1-NN: 3 sub, 3 mul, 2 add a pair on the FP32 pipe (the compare and
# select run on the ALU pipe beside it)
NN1_OPS_PER_PAIR = 8
# csrc/plane_reg.cu, per matrix (a division or root as one): f32, f64
PLANE_F32_OPS, PLANE_F64_OPS = 123, 27
# csrc/lm_trial.cu, per stream: the proposal (solve 213, se3_exp 52, sin
# and cos ~20 each) and the decision
LM_PROPOSE_F32_OPS, LM_DECIDE_F32_OPS = 305, 67
# lm_inner: per point and evaluation of the error, and per trial
LM_POINT_F32_OPS = 45
LM_TRIAL_F32_OPS = LM_PROPOSE_F32_OPS + 112 + LM_DECIDE_F32_OPS


def bound_ms(f32_ops: float = 0.0, bytes_moved: float = 0.0, f64_ops: float = 0.0) -> tuple:
    """(least milliseconds, what bounds it): the larger of the operations
    at the issue rates and the bytes at the HBM rate."""
    ops_ms = (f32_ops / FP32_ISSUE_PER_S + f64_ops / FP64_ISSUE_PER_S) * 1e3
    mem_ms = bytes_moved / PEAK_HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def roofline_pct(bound: float, measured_ms: float) -> float:
    """A kernel's share of its roofline, in percent (never clipped: above
    100 means the work is counted too high or the time too short)."""
    return 100.0 * bound / measured_ms


def nn1_bytes(queries: int, targets: int) -> int:
    """1-NN: each query and target (3 floats) read once, each query's
    packed key (index and distance, 8 bytes) written once."""
    return 12 * queries + 12 * targets + 8 * queries


def nn1_bound_ms(pairs: float, queries: int, targets: int) -> tuple:
    """1-NN over ``pairs`` candidate pairs (the live pairs a sparse sweep
    visits, all Q x T for the dense one)."""
    return bound_ms(f32_ops=pairs * NN1_OPS_PER_PAIR, bytes_moved=nn1_bytes(queries, targets))


def plane_bound_ms(rows: int, live_rows: int, window: int = 384) -> tuple:
    """``window_plane_cov``: 8 operations for each of a live row's window
    pairs (a masked row is the identity whatever its window), against
    every row's point and mask read and covariance written (49 bytes)."""
    return bound_ms(f32_ops=live_rows * window * NN1_OPS_PER_PAIR, bytes_moved=49 * rows)


def lm_propose_bytes(streams: int, zero: bool) -> int:
    """``ddlo_lm_propose``: per stream H's lower triangle (21 floats), b,
    lam (and the 1-byte zero flag) read, d and delta written."""
    return streams * (4 * (21 + 6 + 1) + int(zero) + 4 * (6 + 16))


def lm_decide_bytes(streams: int, accepted: int, ended: int) -> int:
    """``ddlo_lm_decide``: per stream y0, yi, lam, nu, d, b, delta's 3 x 4
    top and four flags read, lam, nu and the flags written, j once;
    accepted streams read xi and write x, ended ones read delta's last row
    and write delta_done."""
    per = 4 * (4 + 6 + 6 + 12) + 4 + 4 * 2 + 4
    return streams * per + 8 + accepted * 4 * (16 + 16) + ended * 4 * (4 + 16)


def lm_inner_bytes(N: int, active: int, streams: int) -> int:
    """``ddlo_lm_inner``: each stream that runs trials reads its N points
    once (source 12, M 36, B 12, validity 1 bytes), H's lower triangle, b,
    lam and x0; every stream reads two flags and writes lam, nu, x,
    delta_done, four flags and its count."""
    return active * (61 * N + 4 * (21 + 6 + 1 + 16)) + streams * (2 + 4 * (2 + 16 + 16) + 4 + 4)


def lm_inner_bound_ms(N: int, active: int, streams: int, trials: int) -> tuple:
    """The whole lambda loop: each trial's error over the live points and
    its proposal and decision, against the bytes above."""
    ops = trials * (N * LM_POINT_F32_OPS + LM_TRIAL_F32_OPS)
    return bound_ms(f32_ops=ops, bytes_moved=lm_inner_bytes(N, active, streams))


def plane_reg_bound_ms(rows: int) -> tuple:
    """``ddlo_plane_reg``: each matrix's f32 and f64 operations, against
    its covariance read and written (36 bytes each way)."""
    return bound_ms(f32_ops=rows * PLANE_F32_OPS, f64_ops=rows * PLANE_F64_OPS, bytes_moved=72 * rows)
