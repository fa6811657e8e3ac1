"""The voxel convolutions' share of their roofline: the bound of every
3x3x3 conv + GroupNorm the traced calls ran (from each call's shapes:
operations over the bf16 peak or bytes over the HBM bandwidth, the larger)
over the device time attributed to ``models.pvcnn.conv3d_gn``."""

from portbench.bounds import conv_bound_s

TARGET = "models.pvcnn.conv3d_gn"


def _record(out, x, weight, *args, **kwargs):
    return (x.shape[0], x.shape[1], weight.shape[3], weight.shape[4], x.element_size())


SPANS = {TARGET: _record}


def read(tracer):
    device_s = tracer.attributed_s(TARGET)
    span = tracer.spans.get(TARGET)
    if not device_s or span is None or not span.calls:
        return None
    return 100.0 * sum(conv_bound_s(*rec) for rec, _ in span.calls) / device_s
