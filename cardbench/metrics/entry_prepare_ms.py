"""entry_prepare_ms: host milliseconds a step in ``entry.prepare``: the
inputs put on the device and the graph found by its signature
(``pipeline.step``, the batched step): the host spans' sums on the
program's device counts over the traced stretch, over the stretch's
graph launches (``host.entry.launch.n``), a step as ``entry_host_ms``
counts it. Taken under the profiler: the traced stretch is
CUPTI-profiled, and there the graph launches node by node and a fleet's
branches run one after another, so it reads above the unprofiled program
(PERF.md §5 has both). Layer: entry."""


def read(view):
    n = view.counts.get("host.entry.launch.n")
    ns = [view.counts.get(k) for k in ["host.entry.prepare.ns"]]
    return sum(ns) / 1e6 / n if n and all(ns) else None
