"""PU-Net 50k object denoising throughput of the port on one CUDA card.

  python -m p2p_bridge_tpu_torch.bench [--seed 0]

The port's counterpart of the root bench.py, at its settings: PVDS_PUNet
as shipped (bf16), random weights from ``--seed``, 4 clouds of 50,000
points (normal draws scaled into the unit sphere), patch size 2048, seed_k
3, 5 steps, bucketed recombination, one warm-up call first. It measures

* ``best_points_per_sec``: the best of 3 synchronous calls (host clock);
* ``value``, the headline: 6 calls with ``as_numpy=False`` dispatched back
  to back and pulled at the end, over the host clock; every one of them
  must be ``torch.equal`` to the warm-up's output (the bf16 path is
  deterministic), or the bench fails;
* ``device_points_per_sec``: over the device-busy time of one call, the
  union of the device's kernel, copy and set intervals in a torch.profiler
  trace;
* ``mfu`` / ``device_mfu``: the model FLOPs of the 5 forwards at B = 73 of
  each cloud (utils/flops.py) over the steady-state wall per call / the
  device-busy time, over the card's bf16 dense peak (989 TFLOP/s, NVIDIA
  H100 SXM data sheet);
* ``overlap_ms``: from a profiler window over three pipelined calls with a
  marker kernel launched between calls, how long before the device ended a
  call's last kernel the host had queued the next call (negative: the
  device waited for the host); ``host_syncs``, the synchronising CUDA
  runtime calls the window holds (0: nothing on the path waits);
* ``room_points_per_sec``: one PVDL_SNPP row (bf16, 32 patches x 4096
  points, 384 seeded condition channels, 10 steps), best of 3 after a
  warm-up, the prediction finite.

It prints ONE JSON line with those keys, ``metric``, ``unit`` and
``device`` (name, power limit, count). Without a CUDA card it raises; any
failed row ends the run with its traceback and a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from .config import pvdl_snpp, pvds_punet
from .inference import patch_based_denoise_batch
from .models.p2pb import P2PBridge
from .models.unet_pvc import build_unet_from_config, init_parameters
from .utils.flops import forward_flops

METRIC = "punet50k_denoise_points_per_sec"
UNIT = "points/sec/gpu"
N_OBJECTS = 4
N_POINTS = 50_000
SEED_K = 3
STEPS = 5
BEST_OF = 3
R_STEADY = 6
ROOM_BATCH = 32
ROOM_POINTS = 4096  # PVDL_SNPP's data.npoints
ROOM_STEPS = 10
PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16
SPINS = 32  # spin kernels each traced window opens with, left out of its sums
WINDOW = "bench_window"  # the host range of the traced calls
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the clouds, the room inputs and the random weights")
    return parser.parse_args(argv)


def object_clouds(seed: int) -> np.ndarray:
    """[N_OBJECTS, N_POINTS, 3] normal draws, each cloud scaled to a
    largest norm of 1 (the root bench.py's inputs)."""
    pcls = np.random.default_rng(seed).normal(size=(N_OBJECTS, N_POINTS, 3)).astype(np.float32)
    return pcls / np.linalg.norm(pcls, axis=-1, keepdims=True).max(axis=1, keepdims=True)


def device_info() -> dict:
    """{name, power_limit_w, count} of the card, the limit as nvidia-smi
    gives it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    limit = smi.rsplit(",", 1)[1].strip()
    return {"name": torch.cuda.get_device_name(0),
            "power_limit_w": float(limit.split()[0]) if limit[:1].isdigit() else limit,
            "count": torch.cuda.device_count()}


def result_line(*, steady_s: float, best_s: float, device_s: float, model_flops: float,
                room_best_s: float, overlap_ms: float, host_syncs: int, device: dict) -> dict:
    """The bench's JSON object from its measurements: ``steady_s`` and
    ``best_s`` are seconds a call (the steady state's wall over its calls,
    the best synchronous call), ``device_s`` the device-busy seconds of one
    call, ``model_flops`` the model FLOPs of one call."""
    points, room_points = N_OBJECTS * N_POINTS, ROOM_BATCH * ROOM_POINTS
    return {
        "metric": METRIC, "value": points / steady_s, "unit": UNIT,
        "best_points_per_sec": points / best_s,
        "device_points_per_sec": points / device_s,
        "mfu": model_flops / steady_s / PEAK_BF16_FLOPS,
        "device_mfu": model_flops / device_s / PEAK_BF16_FLOPS,
        "room_points_per_sec": room_points / room_best_s,
        "model_tflop_per_call": model_flops / 1e12,
        "steady_ms_per_call": steady_s * 1e3, "best_ms": best_s * 1e3,
        "device_busy_ms": device_s * 1e3, "room_best_ms": room_best_s * 1e3,
        "overlap_ms": overlap_ms, "host_syncs": host_syncs,
        "device": device,
    }


def trace(fn: Callable[[], None]):
    """Run ``fn`` under torch.profiler (CPU and CUDA) after SPINS spin
    kernels, and return the trace's events (a trace late in a process
    loses the records of its first kernels; the spins take that loss),
    ``fn``'s host time marked as the range WINDOW."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(SPINS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    with record_function(WINDOW):
        fn()
    torch.cuda.synchronize()
    prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_spans(events, spins: bool = False) -> list:
    """[(name, start us, end us, correlation)] of the device's kernels,
    copies and sets, in start order; the spin kernels are left out unless
    ``spins``."""
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("correlation"))
             for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sorted((s for s in spans if spins or "spin_kernel" not in s[0]),
                  key=lambda s: s[1])


def busy_seconds(spans) -> float:
    """The union of the spans' intervals, in seconds."""
    busy, end = 0.0, -float("inf")
    for _, a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def pipelined_overlap(events) -> tuple:
    """(the least lead in ms, the synchronising runtime calls inside the
    WINDOW range) of a window of calls with a spin kernel launched between
    each two (after the window's opening spins): each lead is the device
    end of the last span before such a marker minus the host time the
    marker was launched, the marker queued with the next call's work."""
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    window = next(e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime" and e["name"] in SYNC_CALLS
                and window["ts"] <= e["ts"] <= window["ts"] + window["dur"])
    spans = device_spans(events, spins=True)
    first = next(i for i, s in enumerate(spans) if "spin_kernel" not in s[0])
    leads = []
    for i in range(first + 1, len(spans)):
        name, _, _, corr = spans[i]
        if "spin_kernel" in name and corr in launches:
            last_end = max(s[2] for s in spans[first:i] if "spin_kernel" not in s[0])
            leads.append((last_end - launches[corr]) / 1e3)
    if not leads:
        raise RuntimeError("the profiler window holds no marker kernel with its launch")
    return min(leads), syncs


def objects_row(seed: int, dev: torch.device) -> dict:
    cfg = pvds_punet()
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(seed))
    bridge = P2PBridge.from_config(cfg, model.to(dev))
    pcls = object_clouds(seed)
    patch = cfg["data"]["npoints"]

    def run(as_numpy: bool = True):
        return patch_based_denoise_batch(bridge, pcls, patch_size=patch, seed_k=SEED_K,
                                         steps=STEPS, recombine_mode="bucketed", device=dev,
                                         as_numpy=as_numpy)[0]

    reference = torch.from_numpy(run())  # warm-up; the single synchronous call
    if reference.shape != (N_OBJECTS, N_POINTS, 3) or not torch.isfinite(reference).all():
        raise AssertionError(f"denoised clouds {tuple(reference.shape)}, finite "
                             f"{bool(torch.isfinite(reference).all())}")
    times = []
    for _ in range(BEST_OF):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    outs = [run(as_numpy=False) for _ in range(R_STEADY)]
    outs = [o.cpu() for o in outs]
    steady = (time.perf_counter() - t0) / R_STEADY
    for i, out in enumerate(outs):
        if not torch.equal(out, reference):
            raise AssertionError(f"pipelined call {i} differs from the synchronous call by up "
                                 f"to {(out - reference).abs().max().item()}")

    device_s = busy_seconds(device_spans(trace(run)))

    def pipelined():
        for k in range(3):
            if k:
                torch.cuda._sleep(1)  # the marker between two calls
            run(as_numpy=False)

    overlap_ms, syncs = pipelined_overlap(trace(pipelined))
    patches = int(SEED_K * N_POINTS / patch)
    return {"steady_s": steady, "best_s": min(times), "device_s": device_s,
            "model_flops": float(forward_flops(cfg, patches) * STEPS * N_OBJECTS),
            "overlap_ms": overlap_ms, "host_syncs": syncs}


def room_row(seed: int, dev: torch.device) -> float:
    """Best seconds of one PVDL_SNPP sampling of ROOM_BATCH patches."""
    cfg = pvdl_snpp()
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(seed + 1))
    bridge = P2PBridge.from_config(cfg, model.to(dev))
    rng = np.random.default_rng(seed + 1)
    n, feats = cfg["data"]["npoints"], cfg["model"]["extra_feature_channels"]
    x = torch.from_numpy((rng.normal(size=(ROOM_BATCH, n, 3)) * 0.3).astype(np.float32)).to(dev)
    cond = torch.from_numpy(rng.normal(size=(ROOM_BATCH, n, feats)).astype(np.float32)).to(dev)

    def run():
        out = bridge.sample(x, cond, steps=ROOM_STEPS, log_count=1)["x_pred"]
        torch.cuda.synchronize()
        return out

    if not torch.isfinite(run()).all():
        raise AssertionError("the room prediction is not finite")
    times = []
    for _ in range(BEST_OF):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA card, and none is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        objects = objects_row(args.seed, dev)
        room_s = room_row(args.seed, dev)
    line = result_line(room_best_s=room_s, device=device_info(), **objects)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
