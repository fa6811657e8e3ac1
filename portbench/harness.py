"""The cell runner, driven by ``BENCHMARK.json`` and the files it names.

``run_cell`` takes the device and the clock from its caller, so that the
tests can drive a whole run on the CPU at a small size; ``run.py`` gives
it the card.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Callable, Optional

import torch

from .tracing import PACKAGE, Tracer


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no cell named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str):
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return e2e, layers


def load_config(root: Path, bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def load_json(root: Path, kind: str, name: str) -> dict:
    return json.loads((root / "portbench" / kind / f"{name}.json").read_text())


def load_reader(root: Path, metric: str):
    """The module ``layers/<metric>.py``: ``SPANS`` {target: record or
    None} and ``read(tracer) -> value or None``."""
    path = root / "portbench" / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.layers.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_info(device: torch.device, count: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=30)
        info["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def run_cell(root: Path, bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, clock: Callable[[], float], cfg: Optional[dict] = None,
             traffic: Optional[dict] = None, limits: Optional[dict] = None) -> dict:
    """Set up, warm up, run the window (traced: then a short traced one),
    free the program's state and check what it produced. -> the result
    line, ``checks`` last.
    ``cfg``, ``traffic`` and ``limits`` stand in for the cell's files."""
    cfg = cfg if cfg is not None else load_config(root, bench, cell["config"])
    traffic = traffic if traffic is not None else load_json(root, "traffic", cell["traffic"])
    limits = limits if limits is not None else load_json(root, "limits", cell["name"])
    e2e, layers = cell_metrics(bench, cell["name"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver_cls = importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver
    driver = driver_cls(cfg, traffic, seed, device)
    driver.warm()
    setup_s = clock()
    line: dict = {}
    if trace:
        driver.window(seconds)  # untraced, for the rates the per-layer shares of peak read
        tracer = Tracer(PACKAGE)
        tracer.info.update(model_flops=driver.done_flops, window_s=driver.elapsed)
        readers = {m["name"]: load_reader(root, m["name"]) for m in layers}
        for reader in readers.values():
            for target, record in getattr(reader, "SPANS", {}).items():
                tracer.span(target, record)
        driver.trace(tracer)
        values = {}
        for name, reader in readers.items():
            value = reader.read(tracer)
            if value is None:
                print(f"portbench: {name} found nothing to read", file=sys.stderr)
            else:
                values[name] = value
        reported = layers
        attempted = tracer.units
    else:
        values = dict(driver.window(seconds), setup_s=setup_s)
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver measured no {', '.join(missing)}")
        reported = e2e
        attempted = driver.attempted
    metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
               for m in reported if m["name"] in values}
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    info = device_info(device, cell["chips"], peak)
    if trace:
        info.update(busy_s=tracer.busy_s(), window_s=tracer.window_s())
        line["breakdown"] = tracer.breakdown()
        tracer.events = None
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, correct = {}, True
    for name, value in driver.check():
        if name not in limits:
            raise KeyError(f"no limit for the number {name!r} of cell {cell['name']}")
        checks[name] = {"value": float(value), "limit": float(limits[name])}
        correct = correct and math.isfinite(value) and value <= limits[name]
    return {"correct": bool(correct), "attempted": int(attempted), "failed": int(driver.failed),
            "metrics": metrics, "device": info, **line, "checks": checks}


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
