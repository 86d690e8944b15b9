"""entry_launch_ms: host milliseconds a step in ``entry.launch``: the
graph's replay, the ``cudaGraphLaunch`` (``core/control.Graph``): the
host spans' sums on the program's device counts over the traced stretch,
over the stretch's graph launches (``host.entry.launch.n``), a step as
``entry_host_ms`` counts it. Taken under the profiler: the traced
stretch is CUPTI-profiled, and there the graph launches node by node and
a fleet's branches run one after another, so it reads above the
unprofiled program (PERF.md §5 has both). Layer: control."""


def read(view):
    n = view.counts.get("host.entry.launch.n")
    ns = [view.counts.get(k) for k in ["host.entry.launch.ns"]]
    return sum(ns) / 1e6 / n if n and all(ns) else None
