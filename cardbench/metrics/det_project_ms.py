"""det_project_ms: device milliseconds a stream-scan in the
``detection.project`` span, nested in ``detection``: the range image,
the residual image and ground removal (``detection.detect``'s first part,
``ops/projection.py``, ``ops/segmentation.ground_removal``). The
program's stamps (``utils.profiling.mark``) sum into
``span.detection.project.ns`` on its device counts over the traced
stretch, which is CUPTI-profiled (``detection_ms`` says what that does
to a span). None where the program has no such span. Layer:
segmentation."""


def read(view):
    ns = view.counts.get("span.detection.project.ns")
    return ns / 1e6 / view.stream_scans if ns and view.stream_scans else None
