"""Device idle milliseconds a call while the host was innermost in the
program's span ``sampler.step`` (one backbone forward and the sampler's
state update): what the card waited for the host's launches inside the
sampler."""

from portbench.program_spans import idle_ms

SPANS = {}


def read(tracer):
    return idle_ms(tracer, "sampler.step", innermost=True)
