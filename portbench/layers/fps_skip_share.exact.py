"""The share of the cluster FPS's unit passes that its bounding-box test
skipped: the skipped passes each call counted on the card (one int64 a
block, ``ops.fps.cluster_skips``'s first argument) over the passes it could
have skipped (its second: the units that hold points times M - 1), summed
over the traced window's cluster FPS calls and read after the window. A
program whose cluster kernel counts nothing has no such function: None."""

TARGET = "ops.fps.cluster_skips"


def _record(out, skipped, passes, *args, **kwargs):
    return skipped, skipped.shape[0] * int(passes)


SPANS = {TARGET: _record}


def read(tracer):
    span = tracer.spans.get(TARGET)
    if span is None or not span.found or not span.calls:
        return None
    possible = sum(passes for (_, passes), _ in span.calls)
    if not possible:
        return None
    return 100.0 * sum(int(skipped.sum()) for (skipped, _), _ in span.calls) / possible
