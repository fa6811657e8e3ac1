"""Run one cell of the benchmark and print its result line.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the program
(``p2p_bridge_tpu_torch``). The run makes its weights and inputs from the
seed, warms up every shape its traffic uses, then either measures the
cell's end-to-end metrics over a window of ``--seconds`` (``--trace 0``)
or runs that window untraced, then traces a short one, and reads the
cell's per-layer metrics from both (``--trace 1``). After the window it
frees the program's state and holds what the window produced to the plain
reference (``reference/``); each number compared is printed beside its
limit on stderr and under the result's last key, ``checks``. The last line of stdout is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` when traced).

It exits with a code other than 0, printing no result, without a CUDA card
(or with fewer than the cell asks for), when ``jax``, ``jaxlib``, ``flax``,
``optax``, ``orbax`` or the JAX package is loaded once the window has
closed, or when anything fails.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "p2p_bridge_tpu")
# every build and kernel cache at a fixed place inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}
# one thread a numeric library: the host's share of the work runs in one
# process with few threads, so that runs on a shared host spread less
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def set_environment() -> None:
    """The caches and the thread counts, before numpy or torch loads."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    for var in THREADS:
        os.environ[var] = "1"


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_environment()

    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line = harness.run_cell(ROOT, bench, cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), process_age_s)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    harness.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
