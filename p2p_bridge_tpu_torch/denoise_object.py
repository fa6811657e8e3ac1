"""Denoise one object point cloud (.xyz/.ply) with the PyTorch port.

  python -m p2p_bridge_tpu_torch.denoise_object --data_path cloud.xyz \
      --model_path run/checkpoint.pt [--device cuda]

The flags are those of the root denoise_object.py, plus ``--device``.
``--model_path`` names a torch state_dict in the reference's naming
(``.pt``/``.pth``, or a checkpoint dict holding one under ``model`` /
``ema``), an ``.npz`` of JAX params with flattened ``a/b/c`` keys, or a run
directory that ``python -m p2p_bridge_tpu_torch.train`` wrote (its
``model.pt``); the ``opt.yaml`` in that directory, or beside the weights,
gives the configuration. Free ``--a.b value``
arguments override configuration entries. The backbone computes in the
configuration's dtype: bf16 where ``training.amp`` is set and
``model.compute_dtype`` is not (the shipped PVDS_PUNet), f32 with
``--model.compute_dtype f32``.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .inference import normalize_unit_sphere, patch_based_denoise
from .models.model_loader import CHECKPOINT
from .models.p2pb import P2PBridge
from .models.unet_pvc import build_unet_from_config, compute_dtype
from .utils.config import apply_dot_overrides, load_yaml
from .utils.io import load_point_cloud, write_xyz
from .weights import load_jax_params, load_npz, load_torch_state_dict

logger = logging.getLogger("p2pb")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True, help="Path to the object point cloud.")
    parser.add_argument("--output_path", type=str, default=None, help="Output file (.xyz). Defaults next to input.")
    parser.add_argument("--model_path", type=str, required=True,
                        help="Weights: reference torch state_dict (.pt/.pth), JAX params (.npz) or a run directory.")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--k", type=int, default=3, help="Patch oversampling factor.")
    parser.add_argument("--use_ema", action="store_true", help="Use EMA weights of a checkpoint dict.")
    parser.add_argument("--save_intermediate", action="store_true")
    parser.add_argument("--gpu", type=str, default="", help="(accepted for CLI parity; see --device)")
    parser.add_argument("--steps", type=int, default=5, help="Number of diffusion steps.")
    parser.add_argument("--recombine", type=str, default="exact", choices=["exact", "bucketed"],
                        help="Recombination FPS: exact global (reference) or per-patch bucketed.")
    parser.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu.")
    return parser.parse_known_args(argv)


def load_config(model_path: str, overrides) -> dict:
    """opt.yaml in ``model_path`` when it is a directory, else beside the
    weights, else in their directory's parent, with ``--a.b value``
    overrides applied."""
    path = os.path.abspath(model_path)
    base = path if os.path.isdir(path) else os.path.dirname(path)
    for cand in (base, os.path.dirname(base)):
        path = os.path.join(cand, "opt.yaml")
        if os.path.exists(path):
            cfg = load_yaml(path)
            apply_dot_overrides(cfg, list(overrides))
            return cfg
    raise FileNotFoundError(f"opt.yaml not found near {model_path}")


def load_weights(model: torch.nn.Module, path: str, use_ema: bool) -> None:
    """The weights of ``path``: a file, or a run directory's model.pt."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    if path.endswith(".npz"):
        load_jax_params(model, load_npz(path))
        return
    sd = torch.load(path, map_location="cpu", weights_only=True)
    key = "ema" if use_ema else "model"
    if isinstance(sd.get(key), dict):
        sd = sd[key]
    prefix = f"{key}."
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    load_torch_state_dict(model, sd)


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args, overrides = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    cfg = load_config(args.model_path, overrides)
    logger.info("computing in %s", compute_dtype(cfg))
    torch.manual_seed(args.seed)

    model = build_unet_from_config(cfg)
    load_weights(model, args.model_path, args.use_ema)
    bridge = P2PBridge.from_config(cfg, model.to(device).eval())

    pcl = load_point_cloud(args.data_path)["points"]
    logger.info("Loaded %s: %d points", args.data_path, len(pcl))
    pcl_n, center, scale = normalize_unit_sphere(pcl)
    denoised, steps = patch_based_denoise(
        bridge, pcl_n, patch_size=cfg["data"]["npoints"], seed_k=args.k, steps=args.steps,
        recombine_mode=args.recombine, save_intermediate=args.save_intermediate,
        device=device)
    denoised = denoised * scale + center

    out_path = args.output_path or os.path.splitext(args.data_path)[0] + "_denoised.xyz"
    write_xyz(out_path, np.asarray(denoised))
    logger.info("Wrote %s", out_path)
    if steps is not None:
        for t, s in enumerate(steps):
            write_xyz(out_path.replace(".xyz", f"_step{t}.xyz"), s * scale + center)
    return out_path


if __name__ == "__main__":
    main()
