"""Host milliseconds a room in the program's span ``rooms.upload``: each
batch's normalised patches and their feature channels copied to the card
(from pageable memory, so the host waits for the copy)."""

from portbench.program_spans import host_ms

SPANS = {}


def read(tracer):
    return host_ms(tracer, "rooms.upload")
