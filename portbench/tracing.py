"""The traced run: a torch.profiler window over whole requests or steps,
spans opened around the program's functions from outside, and what the
per-layer readers read from the trace.

A span wraps a function of the program where its caller looks it up (the
module or class attribute), opens a ``record_function`` range named after
it for every call, and keeps each call's host time and what its
``record`` takes from the call. The device time attributed to a span is
the sum of the device operations whose launch (matched by the profiler's
correlation id) lies inside one of its ranges. The drivers' checks use
the same wrapper, without ranges, to keep what the program's functions
were called with and returned (``recorder``).
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional

import torch

PACKAGE = "p2p_bridge_tpu_torch"
SPINS = 32  # spin kernels opening the window take the loss of a late trace's first records
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GAPS_NAMED = 500  # the longest idle gaps named by their host operation


def keep(out, *args, **kwargs):
    """A span's ``record`` that keeps the call's arguments and result."""
    return (args, kwargs), out


class Span:
    """A wrapped function of the program: ``calls`` holds (record, host
    seconds) of each call, the record what ``record(result, *args,
    **kwargs)`` returns (None without it)."""

    def __init__(self, target: str, record: Optional[Callable] = None):
        self.target = target
        self.record = record
        self.calls: List[tuple] = []
        self.found = False


class Tracer:
    """Spans by target ("module.attr" or "module.Class.attr" under the
    program's package) and, once the window has run, its trace events;
    without ``ranges`` the wrappers open no profiler range."""

    def __init__(self, package: str = PACKAGE, ranges: bool = True):
        self.package, self.ranges = package, ranges
        self.spans: Dict[str, Span] = {}
        self.events: Optional[list] = None
        self.units = 0  # requests or rooms in the traced window
        self.wall_s = 0.0
        self.info: dict = {}  # what the driver knows of the work

    def span(self, target: str, record: Optional[Callable] = None) -> Span:
        return self.spans.setdefault(target, Span(target, record))

    def recorded(self, target: str) -> list:
        """What the span's record kept of each call, in call order."""
        return [rec for rec, _ in self.spans[target].calls]

    @contextmanager
    def wrapped(self):
        """Install every span's wrapper; a target that does not exist is
        left out (its readers then find nothing) and named on stderr."""
        undo = []
        try:
            for target, span in self.spans.items():
                try:
                    owner, attr = _owner(self.package, target)
                    fn = getattr(owner, attr)
                except (ImportError, AttributeError):
                    print(f"portbench: span {target} not found in {self.package}",
                          file=sys.stderr)
                    continue
                span.found = True
                setattr(owner, attr, _wrapper(fn, span, self.ranges))
                undo.append((owner, attr, fn))
            yield self
        finally:
            for mod, attr, fn in reversed(undo):
                setattr(mod, attr, fn)

    def run(self, fn: Callable[[], int]) -> None:
        """Trace ``fn`` (which returns the units it completed) with the spans
        installed."""
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with self.wrapped():
            prof.start()
            for _ in range(SPINS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.window"):
                self.units = fn()
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - t0
            prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.window = next(e for e in self.events if e.get("name") == "portbench.window"
                           and e.get("ph") == "X" and e.get("cat") == "user_annotation")

    # -- readings -------------------------------------------------------
    def device_ops(self) -> list:
        """[(name, start us, end us, correlation)] of the device's operations
        inside the window, in start order (the opening spins left out)."""
        w0 = self.window["ts"]
        ops = [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("correlation"))
               for e in self.events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and "spin_kernel" not in e["name"] and e["ts"] >= w0]
        return sorted(ops, key=lambda s: s[1])

    def kernels(self) -> int:
        return sum(1 for e in self.events if e.get("ph") == "X" and e.get("cat") == "kernel"
                   and "spin_kernel" not in e["name"] and e["ts"] >= self.window["ts"])

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        busy, end = 0.0, -float("inf")
        for _, a, b, _ in self.device_ops():
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    def window_s(self) -> float:
        """The traced window: its host range, or to the end of its last
        device operation where that is later."""
        w0 = self.window["ts"]
        end = max([self.window["ts"] + self.window["dur"]]
                  + [b for _, _, b, _ in self.device_ops()])
        return (end - w0) / 1e6

    def attributed_s(self, target: str) -> Optional[float]:
        """Device seconds of the operations launched inside the span's
        ranges; None where the span was not installed or holds no launch."""
        span = self.spans.get(target)
        if span is None or not span.found:
            return None
        label = f"portbench.{target}"
        ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.events
                        if e.get("name") == label and e.get("ph") == "X"
                        and e.get("cat") == "user_annotation")
        if not ranges:
            return None
        launches = {e["args"]["correlation"]: e["ts"] for e in self.events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        starts = [a for a, _ in ranges]
        total, hit = 0.0, False
        for _, a, b, corr in self.device_ops():
            ts = launches.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= ranges[i][1]:
                total += b - a
                hit = True
        return total / 1e6 if hit else None

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost host operation running when the gap's
        closing operation was launched."""
        by_name: Dict[str, float] = {}
        ops = self.device_ops()
        for name, a, b, _ in ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        launches = {e["args"]["correlation"]: e for e in self.events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        host: Dict[object, list] = {}  # thread -> [(start, end, name)] by start
        for e in self.events:
            if (e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
                    and e["name"] != "portbench.window"):
                host.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for rows in host.values():
            rows.sort()
        starts = {tid: [r[0] for r in rows] for tid, rows in host.items()}
        found = []  # (idle us, closing operation's correlation)
        end = ops[0][2] if ops else 0.0
        for _, a, b, corr in ops[1:]:
            if a > end:
                found.append((a - end, corr))
            end = max(end, b)
        gaps: Dict[str, float] = {}
        for idle_us, corr in sorted(found, key=lambda g: -g[0])[:GAPS_NAMED]:
            launch = launches.get(corr)
            what = "(no launch record)"
            if launch is not None:
                ts, tid = launch["ts"], launch.get("tid")
                rows = host.get(tid, [])
                what = launch["name"]
                for i in range(bisect.bisect_right(starts.get(tid, []), ts) - 1, -1, -1):
                    if rows[i][1] >= ts:  # the latest-starting range holding the launch
                        what = rows[i][2]
                        break
            gaps[what] = gaps.get(what, 0.0) + idle_us / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}


def recorder(targets) -> Tracer:
    """Spans without ranges that keep every call's arguments and result."""
    tracer = Tracer(ranges=False)
    for target in targets:
        tracer.span(target, keep)
    return tracer


def _owner(package: str, target: str):
    """(the module or class holding the target's last name, that name)."""
    path, attr = target.rsplit(".", 1)
    try:
        return importlib.import_module(f"{package}.{path}"), attr
    except ImportError:
        if "." not in path:
            raise
        mod, cls = path.rsplit(".", 1)
        return getattr(importlib.import_module(f"{package}.{mod}"), cls), attr


def _wrapper(fn, span: Span, ranges: bool):
    label = f"portbench.{span.target}"

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(label) if ranges else nullcontext():
            out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        span.calls.append((span.record(out, *args, **kwargs) if span.record else None, dt))
        return out

    return wrapped
