"""The point branch's fused GroupNorm share of its roofline: the bytes
bound of every ``group_norm_act`` call the traced calls ran (from each
call's shapes: the input read once, the output written once, the f32
affine tables read) over the HBM bandwidth, over the device time
attributed to ``models.modules.group_norm_act``. The kernel's second read
of the input, for its two passes, is its own cost: the bound leaves it out."""

from portbench.bounds import PEAK_F32, bound_s

TARGET = "models.modules.group_norm_act"


def _record(out, x, gamma, beta, *args, **kwargs):
    return (x.numel(), x.element_size(), out.element_size(), gamma.numel() + beta.numel())


SPANS = {TARGET: _record}


def call_bound_s(values: int, in_bytes: int, out_bytes: int, affine_values: int) -> float:
    """One call: bytes over 3.35 TB/s (its dozen f32 operations a value bind
    far later)."""
    return bound_s(0.0, values * (in_bytes + out_bytes) + 4 * affine_values, PEAK_F32)


def read(tracer):
    device_s = tracer.attributed_s(TARGET)
    span = tracer.spans.get(TARGET)
    if not device_s or span is None or not span.calls:
        return None
    return 100.0 * sum(call_bound_s(*rec) for rec, _ in span.calls) / device_s
