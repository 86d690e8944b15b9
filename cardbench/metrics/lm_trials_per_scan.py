"""lm_trials_per_scan: GICP's lambda trials (the sum of each lambda loop's
trial count, ``lm_trials`` on the program's device counts) over the
traced stretch, per stream-scan: at least one per LM iteration of S2S
and S2M. Counted over the profiled stretch; a count, which the profiler
does not change. Layer: GICP (``ops/gicp.py``)."""


def read(view):
    n = view.counts.get("lm_trials")
    return n / view.stream_scans if n and view.stream_scans else None
