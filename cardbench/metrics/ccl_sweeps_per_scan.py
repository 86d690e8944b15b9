"""ccl_sweeps_per_scan: connected-component sweeps on the program's device
counts (key ``ccl_sweeps``) over the traced stretch, per stream-scan.
Layer: segmentation (``ops/segmentation.py``)."""


def read(view):
    n = view.counts.get("ccl_sweeps")
    return n / view.stream_scans if n and view.stream_scans else None
