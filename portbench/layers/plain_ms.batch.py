"""Device milliseconds a call of the kernels launched inside the program's
``sampler.step`` ranges whose name holds ``at::native::``: PyTorch's own
elementwise, reduction and copy kernels of the backbone and the sampler,
the plain work beside the hand-written kernels."""

from portbench.program_spans import kernels_launched

SPANS = {}


def read(tracer):
    kernels = kernels_launched(tracer, "sampler.step")
    if kernels is None or not tracer.units:
        return None
    return sum(b - a for name, a, b in kernels if "at::native::" in name) / 1e3 / tracer.units
