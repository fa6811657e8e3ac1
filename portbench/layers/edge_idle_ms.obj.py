"""Device idle milliseconds a call while the host was in the program's span
``inference.denoise`` but outside every ``sampler.step``: the call's edges
(upload, seeding FPS, kNN patches, normalisation, recombination and the
download)."""

from portbench.program_spans import idle_ms

SPANS = {}


def read(tracer):
    return idle_ms(tracer, "inference.denoise", outside=("sampler.step",))
