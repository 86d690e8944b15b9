"""device_busy_ms_per_scan: milliseconds in which at least one device
operation ran (the union of their intervals, as ``device_busy_us``
computes it) over the traced stretch, per stream-scan. Under the
profiler a fleet step's branches run one after another on the card
(without it they overlap), so for a fleet this reads the branches' work
end to end, not the overlapped time of a plain step. Layer: device."""


def read(view):
    if not view.device or not view.stream_scans:
        return None
    return view.busy_us() / 1e3 / view.stream_scans
