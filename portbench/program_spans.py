"""The program's own spans in a traced window, and what the per-layer
readers read from them.

The program opens a ``torch.profiler.record_function`` range named
``p2pb.<span>`` around its phases while a profiler records (its
``utils/spans.py``): on the host thread that runs the window, on the
profiler's clock, linked to the kernels and copies launched inside it by
the profiler's correlation ids. Three readings, each a unit's share (a
room or a call, ``tracer.units``):

* host ms in a span: the summed duration of its ranges;
* the kernels launched inside a span's ranges (matched by correlation id,
  as ``Tracer.attributed_s`` matches the benchmark's own spans): their
  count or their device ms;
* idle ms in a span: the window's idle time (its complement of the union
  of device operations, as ``Tracer.busy_s`` takes it), each idle
  microsecond given to the stack of program spans open on the host at that
  moment, so that the innermost span is the one the host was in and in no
  deeper one.

Each reading is None where the program opened no range of the span (a
program without spans, or without that one), or the window completed no
unit.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Optional, Tuple

from .tracing import LAUNCH_CATS

PREFIX = "p2pb."


def _spans(tracer) -> list:
    """[(start us, end us, span name)] of the program's ranges on the
    window's host thread, in start order."""
    tid = tracer.window.get("tid")
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in tracer.events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX) and e.get("tid") == tid]
    return sorted(spans, key=lambda s: (s[0], -s[1]))  # an outer range before its inner ones


def _ranges(tracer, name: str) -> list:
    return [(a, b) for a, b, n in _spans(tracer) if n == name]


def host_ms(tracer, name: str) -> Optional[float]:
    """Host ms a unit inside the span's ranges."""
    ranges = _ranges(tracer, name)
    if not ranges or not tracer.units:
        return None
    return sum(b - a for a, b in ranges) / 1e3 / tracer.units


def kernels_launched(tracer, name: str) -> Optional[list]:
    """[(kernel's name, start us, end us)] of the window's kernels whose
    launch lies inside one of the span's ranges (which do not overlap one
    another)."""
    ranges = _ranges(tracer, name)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    launches = {e["args"]["correlation"]: e["ts"] for e in tracer.events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    w0 = tracer.window["ts"]
    out = []
    for e in tracer.events:
        if (e.get("ph") != "X" or e.get("cat") != "kernel" or "spin_kernel" in e["name"]
                or e["ts"] < w0):
            continue
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            out.append((e["name"], e["ts"], e["ts"] + e["dur"]))
    return out


def idle_by_stack(tracer) -> Optional[Dict[tuple, float]]:
    """{stack of open program spans, outermost first: idle us}, with () for
    the idle time outside every program span; the values add up to the
    window's idle time. None where the program opened no span."""
    spans = _spans(tracer)
    if not spans:
        return None
    w0 = tracer.window["ts"]
    idle, t = [], w0
    ops = tracer.device_ops()
    for _, a, b, _ in ops:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    w1 = max([w0 + tracer.window["dur"]] + [b for _, _, b, _ in ops])
    if w1 > t:
        idle.append((t, w1))

    # the host's timeline cut where the stack of open spans changes
    segments = []  # (start, end, stack), in order, not overlapping
    stack = []  # [(end, name)]
    t = spans[0][0]

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end = stack[-1][0]
            if end > t:
                segments.append((t, end, tuple(n for _, n in stack)))
                t = end
            stack.pop()

    for a, b, name in spans:
        close(a)
        if stack and a > t:
            segments.append((t, a, tuple(n for _, n in stack)))
        t = max(t, a)
        stack.append((b, name))
    close(float("inf"))

    out: Dict[tuple, float] = {}
    total, i = 0.0, 0
    for a, b in idle:
        total += b - a
        while i < len(segments) and segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            lo, hi = max(a, segments[j][0]), min(b, segments[j][1])
            if hi > lo:
                out[segments[j][2]] = out.get(segments[j][2], 0.0) + hi - lo
            j += 1
    out[()] = total - sum(out.values())
    return out


def idle_ms(tracer, name: str, innermost: bool = False,
            outside: Tuple[str, ...] = ()) -> Optional[float]:
    """Device idle ms a unit while the host was in the span ``name`` (as
    the innermost span, with ``innermost``) and in none of ``outside``."""
    by_stack = idle_by_stack(tracer)
    if by_stack is None or not tracer.units or not _ranges(tracer, name):
        return None
    inside: Callable[[tuple], bool] = ((lambda s: s[-1] == name) if innermost
                                       else (lambda s: name in s))
    us = sum(v for s, v in by_stack.items()
             if s and inside(s) and not any(o in s for o in outside))
    return us / 1e3 / tracer.units
