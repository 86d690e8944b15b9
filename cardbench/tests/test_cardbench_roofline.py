"""The bound arithmetic copied from chip_smoke.py gives the bounds its
runs recorded (PERF.md's kernel tables) at the same shapes."""

import pytest

import roofline


def test_published_peaks_and_issue_rates():
    assert roofline.PEAK_FP32_FLOPS == 67e12 and roofline.PEAK_HBM_BYTES_PER_S == 3.35e12
    assert roofline.FP32_ISSUE_PER_S == 33.5e12  # no FMA fuses under --fmad=false


@pytest.mark.parametrize("bound,expected,by", [
    (roofline.plane_bound_ms(16384, 4601), 4.22e-4, "operations"),  # window_plane_cov, bench scan 15
    (roofline.plane_reg_bound_ms(16384), 3.52e-4, "bytes"),  # regularize_plane
    (roofline.bound_ms(bytes_moved=roofline.lm_propose_bytes(1, True)), 5.97e-8, "bytes"),
    (roofline.bound_ms(bytes_moved=roofline.lm_decide_bytes(1, 0, 0)), 4.06e-8, "bytes"),
    (roofline.lm_inner_bound_ms(16384, 1, 1, 1), 2.98e-4, "bytes"),  # one S2S trial
])
def test_bounds_match_the_recorded_ones(bound, expected, by):
    ms, what = bound
    assert ms == pytest.approx(expected, rel=0.01) and what == by


def test_a_share_is_never_clipped():
    assert roofline.roofline_pct(2.0, 1.0) == 200.0
