"""The exact recombination's share of its roofline: furthest point
sampling of N picks from the S * K denoised patch points of each cloud,
10 f32 operations a point and pick over 67 TFLOP/s, over the device time
attributed to ``inference.recombine_exact``."""

from portbench.bounds import fps_bound_s

TARGET = "inference.recombine_exact"


def _record(out, flats, n, *args, **kwargs):
    return (flats.shape[0], flats.shape[1], int(n))


SPANS = {TARGET: _record}


def read(tracer):
    device_s = tracer.attributed_s(TARGET)
    span = tracer.spans.get(TARGET)
    if not device_s or span is None or not span.calls:
        return None
    return 100.0 * sum(fps_bound_s(*rec) for rec, _ in span.calls) / device_s
