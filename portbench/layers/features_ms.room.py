"""Host milliseconds a room in the program's span ``rooms.features``: the
room's conditioning channels copied to the card once (from pageable
memory, so the host waits for the copy), to be gathered there batch by
batch."""

from portbench.program_spans import host_ms

SPANS = {}


def read(tracer):
    return host_ms(tracer, "rooms.features")
