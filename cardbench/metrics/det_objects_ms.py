"""det_objects_ms: device milliseconds a stream-scan in the
``detection.objects`` span, nested in ``detection``:
``segmentation.segment_objects`` (``csrc/segment_objects.cu`` on the
card), ``bbox.pca_bboxes`` and the dim-ratio relabel of the pixels. The
program's stamps (``utils.profiling.mark``) sum into
``span.detection.objects.ns`` on its device counts over the traced
stretch, which is CUPTI-profiled (``detection_ms`` says what that does
to a span). None where the program has no such span. Layer:
segmentation."""


def read(view):
    ns = view.counts.get("span.detection.objects.ns")
    return ns / 1e6 / view.stream_scans if ns and view.stream_scans else None
