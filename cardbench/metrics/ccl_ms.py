"""ccl_ms: device milliseconds a stream-scan in the ``detection.ccl``
span, nested in ``detection``: ``segmentation.label_components``, the
angle predicate's edges and the run-minimum sweeps until no label
changes (``ccl_sweeps_per_scan`` counts the sweeps). The program's stamps
(``utils.profiling.mark``) sum into ``span.detection.ccl.ns`` on its
device counts over the traced stretch, which is CUPTI-profiled
(``detection_ms`` says what that does to a span). None where the program
has no such span. Layer: segmentation."""


def read(view):
    ns = view.counts.get("span.detection.ccl.ns")
    return ns / 1e6 / view.stream_scans if ns and view.stream_scans else None
