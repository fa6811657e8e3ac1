"""The reader of ``gn_roofline.denoise`` on made-up traces: a known shape
gives a known share, a trace without the span gives nothing."""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT
from portbench import harness
from portbench.tracing import Tracer

TARGET = "models.modules.group_norm_act"


def reader():
    return harness.load_reader(ROOT, "gn_roofline.denoise")


def traced(calls, ranges, kernels) -> Tracer:
    """A 1,000 us window; ``ranges`` [(start, dur)] of the span, ``kernels``
    [(launch, start, end)] in us."""
    t = Tracer("p2p_bridge_tpu_torch")
    span = t.span(TARGET, reader().SPANS[TARGET])
    span.found = True
    span.calls = calls
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": f"portbench.{TARGET}", "ts": a, "dur": d}
           for a, d in ranges]
    for corr, (launch, a, b) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a, "dur": b - a,
                   "args": {"correlation": corr}})
    t.events = ev
    t.window = ev[0]
    return t


def test_the_record_takes_the_calls_shapes():
    x = torch.zeros(73, 512, 32, 64, dtype=torch.bfloat16)
    gamma, beta = torch.zeros(73, 64), torch.zeros(73, 64)
    out = torch.zeros(73, 512, 32, 64, dtype=torch.bfloat16)
    assert reader()._record(out, x, gamma, beta, 8, 1e-5, True, torch.bfloat16) == (
        73 * 512 * 32 * 64, 2, 2, 2 * 73 * 64)


def test_a_known_shape_gives_a_known_share():
    """Two calls of a bf16 [73, 2048, 128] input to bf16 with a per-cloud
    affine, their 4 kernels (2 a call) 50 + 30 us and 60 + 20 us launched in
    the span's ranges; a kernel launched outside counts for nothing."""
    rec = (73 * 2048 * 128, 2, 2, 2 * 73 * 128)
    t = traced([(rec, 1e-4), (rec, 1e-4)], [(10, 20), (400, 20)],
               [(15, 100, 150), (20, 150, 180), (405, 500, 560), (410, 560, 580), (300, 600, 900)])
    bound = (73 * 2048 * 128 * 4 + 4 * 2 * 73 * 128) / 3.35e12
    assert reader().read(t) == pytest.approx(100 * 2 * bound / 160e-6)


def test_no_span_gives_nothing():
    t = traced([], [], [(15, 100, 150)])
    assert reader().read(t) is None
    t = traced([((10, 2, 2, 20), 1e-4)], [], [(15, 100, 150)])  # not installed in the trace
    assert reader().read(t) is None
    t.spans[TARGET].found = False
    assert reader().read(t) is None
