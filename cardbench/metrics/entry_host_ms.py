"""entry_host_ms: host milliseconds of a call into the entry (``pipeline.step``
or the batched step), from the call to its return, before the pose is read:
the mean over the traced run's window steps, which the profiler does not
slow. Layer: entry (``pipeline.py``, ``parallel/sharding.py``)."""


def read(view):
    ms = view.entry_host_ms
    return sum(ms) / len(ms) if ms else None
