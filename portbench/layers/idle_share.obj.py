"""The share of the traced window in which no operation ran on the
device: 1 - the union of the device's kernel, copy and set intervals over
the window."""

SPANS = {}


def read(tracer):
    window = tracer.window_s()
    if window <= 0:
        return None
    return 100.0 * (1.0 - tracer.busy_s() / window)
