"""graph_device_ms: device milliseconds of one replay of the captured step,
from its first node to its last (the ``graph`` span of
``core/control.Graph``: ``span.graph.ns`` over ``span.graph.n`` on the
program's device counts over the traced stretch). Minus the busy time it
is the idle inside the graph; the scan period minus it, the idle that
the host leaves between replays. Taken under the profiler: the traced
stretch is CUPTI-profiled, and there the graph launches node by node and
a fleet's branches run one after another, so it reads above the
unprofiled program (PERF.md §5 has both). Layer: device."""


def read(view):
    ns, n = view.counts.get("span.graph.ns"), view.counts.get("span.graph.n")
    return ns / 1e6 / n if ns and n else None
