"""The PU-Net / PC-Net object evaluation protocol with the PyTorch port
(port of the root evaluate_objects.py).

  python -m p2p_bridge_tpu_torch.evaluate_objects --dataset PUNet \
      --dataset_root data/objects --model_path <run dir> [--device cuda|cpu]

For every resolution and noise level it denoises each test cloud of
``<dataset_root>/<dataset>/pointclouds/test/<res>_<noise>/`` patch by patch
(outputs already written are kept), writes it back in its own frame to
``<output_root>/<dataset>_<res>_<noise>_steps<steps>/``, and scores the
directory with the ``Evaluator`` (unit-sphere Chamfer, point <-> mesh,
sub-sampled approximate and auction EMD) into
``<output_root>/Summary_<dataset>.csv``. The flags are those of the root
CLI plus ``--device`` (default cuda, which raises where there is no card).
The weights and ``opt.yaml`` load as ``denoise_object`` loads them; free
``--a.b value`` arguments override configuration entries.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .inference import normalize_unit_sphere, patch_based_denoise
from .models.evaluation import Evaluator
from .models.model_loader import load_config, load_weights
from .models.p2pb import P2PBridge
from .models.unet_pvc import build_unet_from_config, compute_dtype
from .utils.device import resolve_device
from .utils.io import read_xyz, write_xyz

logger = logging.getLogger("p2pb")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, default="./data/objects/examples/")
    parser.add_argument("--output_root", type=str, default="./output_objects")
    parser.add_argument("--dataset_root", type=str, default="./data/objects/")
    parser.add_argument("--model_path", type=str, required=True,
                        help="Weights: reference torch state_dict (.pt/.pth), JAX params (.npz) or a run directory.")
    parser.add_argument("--dataset", type=str, default="PUNet", choices=["PUNet", "PCNet"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--k", type=int, default=3, help="Patch oversampling factor.")
    parser.add_argument("--use_ema", action="store_true", help="Use EMA weights of a checkpoint dict.")
    parser.add_argument("--save_intermediate", action="store_true")
    parser.add_argument("--gpu", type=str, default="", help="(accepted for CLI parity; see --device)")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--distribution_type", default="none")
    parser.add_argument("--resolutions", type=str, default="10000_poisson,50000_poisson")
    parser.add_argument("--noise_levels", type=str, default="0.01,0.02,0.03")
    parser.add_argument("--recombine", type=str, default="exact", choices=["exact", "bucketed"],
                        help="Recombination FPS: exact global (reference) or per-patch bucketed.")
    parser.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu.")
    return parser.parse_known_args(argv)


def input_iter(input_dir: str):
    """The noisy clouds of a directory, each normalised to the unit sphere."""
    for fn in sorted(os.listdir(input_dir)):
        if fn[-3:] != "xyz":
            continue
        pcl = read_xyz(os.path.join(input_dir, fn)).astype(np.float32)
        pcl, center, scale = normalize_unit_sphere(pcl)
        yield {"pcl_noisy": pcl, "name": fn[:-4], "center": center, "scale": scale}


def main(argv=None) -> str:
    """Run the protocol; returns the Summary CSV's path."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args, overrides = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.model_path, overrides)
    logger.info("computing in %s", compute_dtype(cfg))
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    model = build_unet_from_config(cfg)
    load_weights(model, args.model_path, args.use_ema)
    bridge = P2PBridge.from_config(cfg, model.to(device).eval())

    resolutions = args.resolutions.split(",")
    noise_levels = [float(n) for n in args.noise_levels.split(",")]
    for res in resolutions:
        for noise in noise_levels:
            in_dir = os.path.join(args.dataset_root, args.dataset, "pointclouds", "test",
                                  f"{res}_{noise}")
            if not os.path.isdir(in_dir):
                logger.warning("Input dir %s missing; skipping", in_dir)
                continue
            exp_name = f"{args.dataset}_{res}_{noise}_steps{args.steps}"
            out_dir = os.path.join(args.output_root, exp_name)
            os.makedirs(out_dir, exist_ok=True)
            for item in input_iter(in_dir):
                out_file = os.path.join(out_dir, item["name"] + ".xyz")
                if os.path.exists(out_file):
                    continue
                denoised, _ = patch_based_denoise(
                    bridge, item["pcl_noisy"], patch_size=cfg["data"]["npoints"], seed_k=args.k,
                    steps=args.steps, recombine_mode=args.recombine, device=device)
                write_xyz(out_file, denoised * item["scale"] + item["center"])
                logger.info("Denoised %s (%s, noise %s)", item["name"], res, noise)
            Evaluator(output_pcl_dir=out_dir, dataset_root=args.dataset_root,
                      dataset=args.dataset, summary_dir=args.output_root,
                      experiment_name=exp_name, res_gts="8192_poisson", device=device).run()
    return os.path.join(args.output_root, f"Summary_{args.dataset}.csv")


if __name__ == "__main__":
    main()
