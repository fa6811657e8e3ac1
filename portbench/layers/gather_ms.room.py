"""Host milliseconds a room in the program's span ``rooms.patches`` (a call
of ``create_patches``) less its ``rooms.split_fps``: the gathers of each
neighbourhood's points and features, the padding, the stacking and casts."""

from portbench.program_spans import host_ms

SPANS = {}


def read(tracer):
    patches = host_ms(tracer, "rooms.patches")
    if patches is None:
        return None
    return patches - (host_ms(tracer, "rooms.split_fps") or 0.0)
