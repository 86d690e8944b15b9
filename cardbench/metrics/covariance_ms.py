"""covariance_ms: device milliseconds a stream-scan in the ``covariances``
span: the scan's PLANE covariances, shared by S2S and S2M
(``ops/covariance.py``). The program's stamps (``utils.profiling.mark``,
``%globaltimer``) inside the captured step sum into
``span.covariances.ns`` on its device counts over the traced stretch.
Taken under the profiler: the traced stretch is CUPTI-profiled, and
there the graph launches node by node and a fleet's branches run one
after another, so it reads above the unprofiled program (PERF.md §5 has
both). Layer: covariances."""


def read(view):
    ns = view.counts.get("span.covariances.ns")
    return ns / 1e6 / view.stream_scans if ns and view.stream_scans else None
