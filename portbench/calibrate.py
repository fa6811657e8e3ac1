"""Readings from which a cell's limits are set: the program's numbers and
the control's, on many seeds in one process.

  python3 -m portbench.calibrate --workload <cell> --seeds 11,12,13 [--control fp8]
      [--witness bf16] [--calls N] [--out file.jsonl]

For each seed it makes the cell's weights and inputs, runs ``--calls``
calls of the cell's traffic through the program, and prints the
numbers the check compares; with ``--control`` also those of the
reference computed in that precision and put in the program's place (the
control, which has to come out not correct), with ``--witness`` those of a
second such stand-in; with ``--fault`` the program runs with that fault
planted (``faults.py``). One JSON line a seed; the limits file holds what
``PERF.md`` derives from them. Needs the cell's card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import ROOT, set_environment


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--control", default=None)
    parser.add_argument("--witness", default=None)
    parser.add_argument("--calls", type=int, default=None,
                        help="calls a seed; default the traffic's own")
    parser.add_argument("--fault", default=None,
                        help="plant this fault in the program (portbench/faults.py)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    set_environment()

    import importlib

    import torch

    from . import faults, harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.load_config(ROOT, bench, cell["config"])
    traffic = harness.load_json(ROOT, "traffic", cell["traffic"])
    driver_cls = importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver
    undo = faults.plant(traffic["driver"], args.fault) if args.fault else None
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            row = driver_cls.calibrate(cfg, traffic, seed, torch.device("cuda", 0), args.calls,
                                       args.control, args.witness)
            row.update(cell=cell["name"], seed=seed, seconds=time.perf_counter() - t0,
                       fault=args.fault, device=torch.cuda.get_device_name(0))
            text = json.dumps(row)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
        if undo:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
