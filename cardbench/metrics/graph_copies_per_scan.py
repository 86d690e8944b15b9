"""graph_copies_per_scan: the host's ``cudaMemcpyAsync`` calls in the traced
stretch per stream-scan (the graph's inputs copied in, its outputs cloned,
the scan's upload, the pose's read). Layer: control (``core/control.py``'s
graph replay)."""


def read(view):
    n = view.host_calls("cudaMemcpyAsync")
    return n / view.stream_scans if n and view.stream_scans else None
