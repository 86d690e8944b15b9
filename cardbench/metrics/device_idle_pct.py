"""device_idle_pct: the share of the traced stretch (the host's first CUDA
call to the end of its last) in which no device operation ran, in
percent: what ``device.busy_s`` and ``device.window_s`` give. The
profiler records CUDA activity only (no per-op host events, no labels),
and still adds its own cost to each traced CUDA call, which counts as
idle here; under it a fleet step's branches run one after another
rather than overlapped. Layer: device."""

import stats


def read(view):
    if not view.device or view.hi <= view.lo:
        return None
    return 100.0 * stats.idle_share([(a, b) for a, b, _ in view.device], view.lo, view.hi)
