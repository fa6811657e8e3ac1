"""Build the paired spherical training batches of room scenes (port of the
root preprocess_batches.py).

  python -m p2p_bridge_tpu_torch.preprocess_batches --data_root <scenes> \
      --output_root <out> [--npoints 4096] [--r 0.3] [--feature_type dino] \
      [--name_suffix S] [--workers 4] [--seed 42]

The flags are those of the root CLI. Each scene directory under
``--data_root`` holds ``scans/mesh_aligned_0.05.ply`` (the clean mesh),
``scans/iphone<S>.ply`` (the noisy scan) and, with ``--feature_type F``,
``features/F_iphone<S>.npy`` ([C, N]); its batches go to
``<output_root>/<scene>/points_<i>.npz`` (``data/preprocess.py``
``preprocess_scene``). The scenes are split over ``--workers`` processes
as the root CLI splits them (scene i to worker i mod workers); the
workers are spawned, and the host runtime is built once before they
start.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os

from .data.preprocess import preprocess_scene
from .runtime import get_lib
from .utils.logging import setup_logger

logger = logging.getLogger("p2pb")


def handle_folders(idx: int, folder_batches, args) -> None:
    setup_logger()  # a spawned worker starts with no handler
    for scene in folder_batches[idx]:
        n = preprocess_scene(
            os.path.join(args.data_root, scene),
            os.path.join(args.output_root, scene),
            npoints=args.npoints,
            radius=args.r,
            name_suffix=args.name_suffix,
            feature_type=args.feature_type,
            seed=args.seed,
        )
        logger.info("[worker %d] %s: %d batches", idx, scene, n)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--output_root", type=str, required=True)
    parser.add_argument("--npoints", type=int, default=4096)
    parser.add_argument("--r", type=float, default=0.3)
    parser.add_argument("--name_suffix", type=str, default="")
    parser.add_argument("--feature_type", type=str, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    setup_logger()
    args = parse_args(argv)
    scenes = sorted(
        f for f in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, f))
    )
    workers = max(1, min(args.workers, len(scenes)))
    folder_batches = [scenes[i::workers] for i in range(workers)]
    get_lib()  # build the host runtime here, not in every worker at once

    if workers == 1:
        handle_folders(0, folder_batches, args)
        return
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=handle_folders, args=(i, folder_batches, args))
             for i in range(workers)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    failed = [i for i, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"preprocess_batches: workers {failed} failed "
                           f"(exit codes {[procs[i].exitcode for i in failed]})")


if __name__ == "__main__":
    main()
