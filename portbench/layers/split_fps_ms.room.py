"""Host milliseconds a room in the program's span ``rooms.split_fps``: the
host FPS of each neighbourhood larger than a patch, inside
``create_patches`` (0 where the room's ``rooms.patches`` ran and split
none)."""

from portbench.program_spans import host_ms

SPANS = {}


def read(tracer):
    if host_ms(tracer, "rooms.patches") is None:
        return None
    return host_ms(tracer, "rooms.split_fps") or 0.0
