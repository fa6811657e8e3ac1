"""Device kernels a call launched inside the program's ``sampler.step``
ranges (matched by the profiler's correlation ids); ``launches.obj``
counts every kernel of the call."""

from portbench.program_spans import kernels_launched

SPANS = {}


def read(tracer):
    kernels = kernels_launched(tracer, "sampler.step")
    if kernels is None or not tracer.units:
        return None
    return len(kernels) / tracer.units
