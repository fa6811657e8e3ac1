"""Host milliseconds a room in the program's span ``rooms.seed``: the
room-wide seeding FPS (``bucket_fps``), the KD-tree's build and its radius
query, with the neighbourhoods' conversion to index arrays."""

from portbench.program_spans import host_ms

SPANS = {}


def read(tracer):
    return host_ms(tracer, "rooms.seed")
