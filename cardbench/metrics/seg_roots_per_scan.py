"""seg_roots_per_scan: components at or above the candidate gate's minimum
size on the program's device counts (key ``seg_roots``) over the traced
stretch, per stream-scan; beside the candidate budget (K = 128 in
doals-os1-64) it says whether the budget binds. Layer: segmentation
(``ops/segmentation.py`` ``segment_objects``)."""


def read(view):
    n = view.counts.get("seg_roots")
    return n / view.stream_scans if n and view.stream_scans else None
