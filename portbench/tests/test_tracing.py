"""The trace arithmetic and the per-layer readers, on a made-up trace."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench import harness
from portbench.tracing import Tracer

BENCH = harness.load_benchmark(ROOT)
READERS = sorted(p.stem for p in (ROOT / "portbench" / "layers").glob("*.py"))


def made_up() -> Tracer:
    """A window of 1,000 us: kernels at 100-300 (launched at 50 inside the
    span's range 40-60), 250-400 (launched at 70, outside) and 600-700
    (launched at 500 inside the span's second range 450-520)."""
    t = Tracer("p2p_bridge_tpu_torch")
    conv = t.span("models.pvcnn.conv3d_gn", None)
    conv.found = True
    conv.calls = [((4, 8, 32, 32, 2), 0.001), ((4, 8, 32, 32, 2), 0.001)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.models.pvcnn.conv3d_gn",
           "ts": 40, "dur": 20},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.models.pvcnn.conv3d_gn",
           "ts": 450, "dur": 70},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 60, "dur": 20, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 480, "dur": 30, "tid": 1}]
    for corr, (launch, a, b) in enumerate(((50, 100, 300), (70, 250, 400), (500, 600, 700))):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a, "dur": b - a,
                   "args": {"correlation": corr}})
    t.events = ev
    t.window = ev[0]
    t.units, t.wall_s = 2, 1e-3
    t.info = {"model_flops": 989e12 * 2.0 * 0.25, "window_s": 2.0}
    return t


def test_busy_window_attribution_and_launches():
    t = made_up()
    assert t.busy_s() == pytest.approx(400e-6)  # 100-400 and 600-700
    assert t.window_s() == pytest.approx(1000e-6)
    assert t.attributed_s("models.pvcnn.conv3d_gn") == pytest.approx(300e-6)  # k0 + k2
    assert t.attributed_s("inference.recombine_exact") is None
    assert t.kernels() == 3


def test_breakdown_names_the_gaps_by_the_host_operation():
    b = made_up().breakdown()
    assert b["device_ops"][0] == ["k0", pytest.approx(200e-6)]
    assert b["idle_gaps"] == [["aten::add", pytest.approx(200e-6)]]  # 400-600, k2 launched in add


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_a_number_or_nothing(name):
    value = harness.load_reader(ROOT, name).read(made_up())
    assert value is None or value >= 0
    shares = {m["name"] for m in BENCH["per_layer"] if m["unit"] == "%"}
    if (name in shares or name.startswith(("mfu.", "idle_share."))) and value is not None:
        assert value <= 100


def test_reader_values():
    t = made_up()
    read = {name: harness.load_reader(ROOT, name).read(t) for name in READERS}
    assert read["idle_share.obj"] == pytest.approx(60.0)
    assert read["launches.obj"] == pytest.approx(1.5)
    assert read["mfu.denoise"] == pytest.approx(25.0)
    assert read["fps_roofline.exact"] is None  # no such span in the trace
    conv = 2 * max(2.0 * 4 * 8 ** 3 * 27 * 32 * 32 / 989e12, (4 * 8 ** 3 * 64 + 27 * 1024) * 2 / 3.35e12)
    assert read["conv_roofline.denoise"] == pytest.approx(100 * conv / 300e-6)
