#!/usr/bin/env python3
"""Profile the bf16 50k denoise (bucketed recombination) of one checkout of
the port, so that two checkouts can be compared on one card.

  python3 profile_denoise.py [--checkout DIR] [--runs 3]

Imports chip_smoke.py and p2p_bridge_tpu_torch from DIR (default: the
directory of this script), builds DIR's kernels and PVDS_PUNet at full
width as shipped (bf16, weights from seed 0), denoises one 50,000-point
cloud once to warm up, then RUNS times: one denoise under torch.profiler
(32 spin kernels first, then DIR's chip_smoke.device_time: host wall,
device busy, idle share, device time by kernel group) and one without the
profiler (CUDA events). Run it for two checkouts in alternation, in one
call, to compare them. Prints one JSON object as its last line; needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    checkout = str(Path(args.checkout).resolve())
    sys.path.insert(0, checkout)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from p2p_bridge_tpu_torch.config import pvds_punet
    from p2p_bridge_tpu_torch.models.p2pb import P2PBridge

    cs.require_card()
    cs.build_kernels()
    dev = torch.device("cuda", 0)
    model, twin = cs.build_models(dev)
    del twin
    bridge = P2PBridge.from_config(pvds_punet(), model)
    pcl = cs.cloud_50k()
    cs.denoise(bridge, pcl, "bucketed", dev)  # warm-up
    runs = []
    for _ in range(args.runs):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        for _ in range(32):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.denoise(bridge, pcl, "bucketed", dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.stop()
        traced = cs.device_time(prof, wall_ms, "bf16 bucketed")
        runs.append({"profiled": traced, "denoise_ms": cs.denoise(bridge, pcl, "bucketed", dev)})
    print(json.dumps({"checkout": checkout, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
