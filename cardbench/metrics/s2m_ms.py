"""s2m_ms: device milliseconds a stream-scan in the ``s2m`` span:
scan-to-submap GICP with its residual pass, through the world transform
(``ops/gicp.py``). The program's stamps (``utils.profiling.mark``,
``%globaltimer``) inside the captured step sum into ``span.s2m.ns`` on
its device counts over the traced stretch. Taken under the profiler: the
traced stretch is CUPTI-profiled, and there the graph launches node by
node and a fleet's branches run one after another, so it reads above the
unprofiled program (PERF.md §5 has both). Layer: GICP."""


def read(view):
    ns = view.counts.get("span.s2m.ns")
    return ns / 1e6 / view.stream_scans if ns and view.stream_scans else None
