"""Model FLOPs of every forward of the calls completed in the run's
untraced window (the frozen counter, ``portbench/flops.py``) over the
window's time on the host clock, as a share of the H100's bf16 dense peak
(989 TFLOP/s). The untraced window leaves the profiler's host cost out."""

from portbench.bounds import PEAK_BF16

SPANS = {}


def read(tracer):
    flops, seconds = tracer.info.get("model_flops"), tracer.info.get("window_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / PEAK_BF16
