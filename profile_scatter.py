#!/usr/bin/env python3
"""Time kernel scatter_rows (the backward scatter of K3, K4 and K6) of one
checkout of the port at every backward scatter of a training step, so that
two checkouts can be compared on one card.

  python3 profile_scatter.py [--checkout DIR] [--runs 2] [--host-vs OTHER]

Imports chip_smoke.py and p2p_bridge_tpu_torch from DIR (default: the
directory of this script), builds DIR's kernels and takes DIR's
chip_smoke.scatter_cases at the PVDS_PUNet step (B = 32 x 2048) and the
PVDL_SNPP step (B = 4 x 4096), bf16 and f32. Each call is held torch.equal
to the plain version run on the CPU; then, RUNS times, its device time by
device function (a torch.profiler trace of 10 calls: the table build and
the row pass), its card time (CUDA events), its host time a call, and one
index_add_ of the precomputed terms. Run it for two checkouts in
alternation, in one call, to compare them. With --host-vs OTHER it also
builds OTHER's kernels and times the host side of both C entry points
(p2pb_scatter_rows, no synchronise) in one process, in alternation, on
the same arguments. Prints one JSON object as its last line; needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def device_split(cs, fn, calls: int = 10) -> dict:
    """Mean duration of each scatter_rows device function over a trace of
    ``calls`` calls of ``fn``, by function name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for name, _, dur in cs.trace_events(prof):
        if "scatter_" in name:
            fn_name = name.split("::")[-1].split("<")[0].split("(")[0]
            n, ms = split.get(fn_name, (0, 0.0))
            split[fn_name] = (n + 1, ms + dur / 1e3)
    return {f: ms / n for f, (n, ms) in split.items()}


def step(cs, dev, shapes, b: int, dtype, runs: int) -> dict:
    """Sums over one training step's scatter calls of ``b`` clouds."""
    import numpy as np
    import torch

    out = {"device_ms_by_function": {}, "device_ms": [], "ms": 0.0, "host_us": [],
           "library_ms": 0.0, "calls": []}
    for what, calls, kernel, plain_fn, args, rows, (flat, src), _, _ in cs.scatter_cases(
            np.random.default_rng(13), dev, dtype, shapes, b):
        got = kernel(*args)
        want = plain_fn(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"scatter_rows {what}: differs from the CPU plain version")
        splits = [device_split(cs, lambda: kernel(*args)) for _ in range(runs)]
        ms = cs.time_ms(lambda: kernel(*args))
        hus = cs.host_us(lambda: kernel(*args), ms)
        acc = torch.zeros(b * rows, src.shape[-1], device=dev)
        lib = cs.time_ms(lambda: acc.index_add_(0, flat, src))
        for f in splits[0]:
            out["device_ms_by_function"].setdefault(f, [0.0] * runs)
            for i, s in enumerate(splits):
                out["device_ms_by_function"][f][i] += calls * s.get(f, 0.0)
        out["ms"] += calls * ms
        out["library_ms"] += calls * lib
        out["host_us"].append((calls, hus))
        out["calls"].append({"what": what, "calls": calls, "entries": flat.numel() // b,
                             "rows": rows, "device_ms_by_function": splits, "ms": ms,
                             "host_us": hus, "library_ms": lib})
    out["device_ms"] = [sum(v[i] for v in out["device_ms_by_function"].values())
                        for i in range(runs)]
    n = sum(c for c, _ in out["host_us"])
    out["host_us"] = sum(c * h for c, h in out["host_us"]) / n
    return out


def host_vs(cs, dev, shapes, b: int, dtype, other: str, rounds: int = 4,
            calls: int = 200) -> dict:
    """Host us a call of this checkout's C entry p2pb_scatter_rows and of
    OTHER's, on the arguments the wrapper passes at each scatter call of
    the step, ``calls`` calls a turn, ``rounds`` turns each in alternation:
    {"this": us, "other": us}, means over the step's calls weighted by
    their count."""
    import ctypes
    import subprocess
    import time

    import numpy as np
    import torch
    from p2p_bridge_tpu_torch import kernels

    path = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); from "
         "p2p_bridge_tpu_torch import kernels; print(kernels.build())", other],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
    fns = {"this": kernels.entry_points()["p2pb_scatter_rows"],
           "other": getattr(ctypes.CDLL(path), "p2pb_scatter_rows")}
    fns["other"].restype, fns["other"].argtypes = kernels._SIGNATURES["p2pb_scatter_rows"]
    launch, seen = kernels.launch, []
    totals, weight = {"this": 0.0, "other": 0.0}, 0
    for what, count, kernel, _, args, *_ in cs.scatter_cases(
            np.random.default_rng(13), dev, dtype, shapes, b):
        kernels.launch = lambda *a: (seen.append(a), launch(*a))
        try:
            out = kernel(*args)  # the wrapper's arguments, its buffers kept alive
        finally:
            kernels.launch = launch
        _, _, device, *cargs = seen.pop()
        stream = kernels.current_stream(device)
        times = {"this": [], "other": []}
        for turn in range(rounds):
            for name in (("this", "other") if turn % 2 == 0 else ("other", "this")):
                fn = fns[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    if fn(*cargs, device, stream):
                        raise RuntimeError(f"scatter_rows {what}: {name} entry failed")
                times[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        del out
        for name in totals:
            totals[name] += count * float(np.median(times[name]))
        weight += count
    return {name: t / weight for name, t in totals.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--host-vs", default=None,
                        help="another checkout whose C entry's host time to compare")
    args = parser.parse_args()
    checkout = str(Path(args.checkout).resolve())
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from p2p_bridge_tpu_torch.config import pvdl_snpp, pvds_punet
    from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config

    cs.require_card()
    cs.build_kernels()
    dev = torch.device("cuda", 0)
    with torch.device("meta"):
        steps = {"PVDS_PUNet B=32": (cs.main_path_shapes(
            build_unet_from_config(pvds_punet()).plan, cs.PATCH), 32),
            "PVDL_SNPP B=4": (cs.main_path_shapes(
                build_unet_from_config(pvdl_snpp()).plan, 4096), 4)}
    result = {"checkout": checkout, "card": torch.cuda.get_device_name(0)}
    for label, (shapes, b) in steps.items():
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            r = step(cs, dev, shapes, b, dtype, args.runs)
            if args.host_vs:
                r["entry_host_us"] = host_vs(cs, dev, shapes, b, dtype,
                                             str(Path(args.host_vs).resolve()))
                print(f"{label} {name}: host us a call of the C entry {r['entry_host_us']}",
                      flush=True)
            result[f"{label} {name}"] = r
            split = {f: [round(x, 4) for x in v] for f, v in r["device_ms_by_function"].items()}
            print(f"{label} {name}: device {r['device_ms']} ms ({split}), card {r['ms']:.4f} "
                  f"ms, host {r['host_us']:.1f} us a call, one index_add_ of the terms "
                  f"{r['library_ms']:.4f} ms", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
