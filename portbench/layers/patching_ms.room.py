"""Host milliseconds a room inside the program's ``rooms.create_patches``
(the neighbourhoods padded or split by host FPS into fixed-size patches,
with their features)."""

TARGET = "rooms.create_patches"
SPANS = {TARGET: None}


def read(tracer):
    span = tracer.spans.get(TARGET)
    if span is None or not span.calls or not tracer.units:
        return None
    return 1e3 * sum(dt for _, dt in span.calls) / tracer.units
