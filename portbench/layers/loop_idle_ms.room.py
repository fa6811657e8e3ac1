"""Device idle milliseconds a room while the host was in the program's span
``rooms.batches`` (the batch loop) or a span below it (``rooms.upload``,
``sampler.step``): the window's idle time given to the innermost span open
on the host (``portbench/program_spans.py``)."""

from portbench.program_spans import idle_ms

SPANS = {}


def read(tracer):
    return idle_ms(tracer, "rooms.batches")
