"""kernels_per_scan: device operations (kernels, copies, fills) the profiler
saw in the traced stretch, per stream-scan. Counts inside conditional
bodies vary with the data; the run's standard error gives the least and
most operations of a step. Layer: kernels (``csrc/*.cu`` and PyTorch ops)."""


def read(view):
    n = view.device_ops()
    return n / view.stream_scans if n and view.stream_scans else None
