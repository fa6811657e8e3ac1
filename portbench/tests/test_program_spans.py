"""The readers of the program's own spans (``portbench/program_spans.py``)
on made-up traces, against values computed by hand."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench import harness, program_spans
from portbench.tracing import Tracer

ROOM = ("seed_ms.room", "split_fps_ms.room", "gather_ms.room", "upload_ms.room",
        "loop_idle_ms.room")
OBJ = ("step_idle_ms.obj", "edge_idle_ms.obj", "step_launches.obj", "plain_ms.batch")
NATIVE = "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>"


def trace(spans, device, window, units) -> Tracer:
    """A window [0, window) us on host thread 1: the program's ranges
    ``spans`` [(name, start, end)] and device operations ``device``
    [(category, name, launched at, start, end)], each launched from
    thread 1 with its own correlation id."""
    t = Tracer("p2p_bridge_tpu_torch")
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0,
           "dur": window, "tid": 1}]
    for name, a, b in spans:
        ev.append({"ph": "X", "cat": "user_annotation", "name": "p2pb." + name, "ts": a,
                   "dur": b - a, "tid": 1})
    for corr, (cat, name, launch, a, b) in enumerate(device):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": 7,
                   "args": {"correlation": corr}})
    t.events, t.window, t.units = ev, ev[0], units
    return t


def objects() -> Tracer:
    """Two calls folded into one: ``inference.denoise`` 100-900 holding the
    steps 200-400 and 500-700; a copy launched at 150 (160-250), native
    and hand-written kernels launched in the first step (260-380, 380-390),
    a native one in the second (600-750) and one after the steps
    (800-850). Idle: 0-160, 250-260, 390-600 (across the first step's end),
    750-800, 850-1000."""
    return trace([("inference.denoise", 100, 900), ("sampler.step", 200, 400),
                  ("sampler.step", 500, 700)],
                 [("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 150, 160, 250),
                  ("kernel", NATIVE, 210, 260, 380),
                  ("kernel", "(anonymous namespace)::conv_wgmma_kernel<64>", 220, 380, 390),
                  ("kernel", "void at::native::reduce_kernel<512, 1>", 510, 600, 750),
                  ("kernel", NATIVE, 720, 800, 850)], 1000, 2)


def room(splits=(("rooms.split_fps", 400, 500), ("rooms.split_fps", 600, 650))) -> Tracer:
    """One room: ``rooms.seed`` 0-300, ``rooms.patches`` 300-1000 holding
    ``splits``, ``rooms.batches`` 1000-1900 holding the uploads 1000-1100 and
    1400-1450 (the first starting with the loop) and the steps 1100-1400
    and 1450-1800. Idle: 0-1050, 1100-1200, 1600-1700, 1950-2000."""
    return trace([("rooms.seed", 0, 300), ("rooms.patches", 300, 1000), *splits,
                  ("rooms.batches", 1000, 1900), ("rooms.upload", 1000, 1100),
                  ("sampler.step", 1100, 1400), ("rooms.upload", 1400, 1450),
                  ("sampler.step", 1450, 1800)],
                 [("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1010, 1050, 1100),
                  ("kernel", NATIVE, 1150, 1200, 1500),
                  ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1420, 1500, 1600),
                  ("kernel", NATIVE, 1460, 1700, 1950)], 2000, 1)


def read(name: str, tracer: Tracer):
    return harness.load_reader(ROOT, name).read(tracer)


def test_idle_goes_to_the_innermost_span_and_adds_up_to_the_window():
    t = objects()
    by_stack = program_spans.idle_by_stack(t)
    d, s = "inference.denoise", "sampler.step"
    # 390-600 crosses the first step's end: 10 us in it, 100 in the call
    # between the steps, 100 in the second step
    assert by_stack == {(): 200.0, (d,): 260.0, (d, s): 120.0}
    assert sum(by_stack.values()) == pytest.approx((t.window_s() - t.busy_s()) * 1e6)


def test_an_outer_range_that_starts_with_its_inner_one_holds_it():
    by_stack = program_spans.idle_by_stack(room())
    b, u, s = "rooms.batches", "rooms.upload", "sampler.step"
    assert by_stack == {(): 50.0, ("rooms.seed",): 300.0, ("rooms.patches",): 550.0,
                        ("rooms.patches", "rooms.split_fps"): 150.0, (b, u): 50.0,
                        (b, s): 200.0}


@pytest.mark.parametrize("name, want", [("step_idle_ms.obj", 0.06), ("edge_idle_ms.obj", 0.13),
                                        ("step_launches.obj", 1.5), ("plain_ms.batch", 0.135)])
def test_object_readers(name, want):
    # kernels launched in the steps: 260-380 (native), 380-390, 600-750
    # (native); the copy and the kernel after the steps are left out
    assert read(name, objects()) == pytest.approx(want)


def test_step_launches_are_some_of_the_launches():
    t = objects()
    assert read("step_launches.obj", t) <= read("launches.obj", t) == 2.0


@pytest.mark.parametrize("name, want", [("seed_ms.room", 0.3), ("split_fps_ms.room", 0.15),
                                        ("gather_ms.room", 0.55), ("upload_ms.room", 0.15),
                                        ("loop_idle_ms.room", 0.25)])
def test_room_readers(name, want):
    # host ms with repeated ranges: two splits (100 + 50 us), two uploads
    # (100 + 50); the loop's idle 1000-1050, 1100-1200, 1600-1700
    assert read(name, room()) == pytest.approx(want)


def test_a_room_that_splits_nothing_reads_zero_split_ms():
    t = room(splits=())
    assert read("split_fps_ms.room", t) == 0.0
    assert read("gather_ms.room", t) == pytest.approx(0.7)


@pytest.mark.parametrize("name", ROOM + OBJ)
def test_nothing_to_read_without_the_programs_spans(name):
    t = objects()
    t.events = [e for e in t.events if not e["name"].startswith("p2pb.")]
    assert read(name, t) is None
    t = objects()
    t.units = 0
    assert read(name, t) is None


@pytest.mark.parametrize("name", ROOM)
def test_room_readers_read_nothing_in_an_object_trace(name):
    assert read(name, objects()) is None
