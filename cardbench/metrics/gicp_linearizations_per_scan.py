"""gicp_linearizations_per_scan: ``nn1_sparse`` launches on the program's
device counts (``utils.profiling.device_counts``) over the traced stretch,
per stream-scan: one per LM linearization of S2S and S2M, and S2M's
residual pass. Layer: GICP (``ops/gicp.py``)."""


def read(view):
    n = view.counts.get("nn1_sparse")
    return n / view.stream_scans if n and view.stream_scans else None
