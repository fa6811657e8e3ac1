"""The training CLI's arguments (copy of p2p_bridge_tpu/utils/args.py on
plain nested dicts; tests hold the two equal).

The reference's surface: --config, --name, --save_dir, --model_path,
--restart, --use_ema, free-form --a.b.c overrides, and the derived
``output_dir`` / ``out_sampling``. The distributed flags are accepted for
CLI parity. YAML is read through :mod:`.config`, which imports it inside
its functions.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .config import apply_dot_overrides, load_yaml


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="Path to the config file.")
    parser.add_argument("--name", type=str, default="", help="Name of the experiment.")
    parser.add_argument("--save_dir", default=None, help="path to save models")
    parser.add_argument("--wandb_project", type=str, default="P2P-Bridge", help="wandb project name")
    parser.add_argument("--wandb_entity", type=str, default="", help="wandb entity name")
    parser.add_argument("--model_path", type=str, default="", help="path to model (to continue training)")
    parser.add_argument("--restart", action="store_true", help="restart training from scratch")
    # distributed flags (CLI parity)
    parser.add_argument("--world_size", default=1, type=int, help="Number of distributed hosts.")
    parser.add_argument("--master_address", default="localhost", type=str)
    parser.add_argument("--master_port", default="6021", type=str)
    parser.add_argument("--dist_backend", default="xla", type=str)
    parser.add_argument("--distribution_type", default="single", choices=["multi", "single", None])
    parser.add_argument("--node_rank", default=0, type=int)
    parser.add_argument("--use_ema", action="store_true", default=False,
                        help="Use exponential moving average of model parameters.")
    return parser


def _merge(cfg: dict, other: dict) -> dict:
    """Deep-merge ``other`` on top of ``cfg`` (other wins); returns cfg."""
    for key, value in other.items():
        if isinstance(cfg.get(key), dict) and isinstance(value, dict):
            _merge(cfg[key], value)
        else:
            cfg[key] = value
    return cfg


def parse_args(argv: Optional[List[str]] = None) -> dict:
    parser = build_parser()
    args, remaining = parser.parse_known_args(argv)

    if args.save_dir is not None:
        os.makedirs(args.save_dir, exist_ok=True)
    elif args.model_path != "":
        args.save_dir = os.path.dirname(args.model_path)

    if args.config is not None:
        cfg = load_yaml(args.config)
    elif args.model_path != "":
        opt_yaml = os.path.join(os.path.dirname(args.model_path), "opt.yaml")
        if not os.path.exists(opt_yaml):
            opt_yaml = os.path.join(args.model_path, "opt.yaml")
        cfg = load_yaml(opt_yaml)
    else:
        raise ValueError("config file must be specified or model path must be specified")

    merged = dict(vars(args))
    if not merged.get("name"):
        # the empty CLI default must not replace the name of a resumed run
        merged.pop("name", None)
    _merge(cfg, merged)
    apply_dot_overrides(cfg, remaining)

    if cfg.get("name", "") == "" and cfg.get("config"):
        cfg["name"] = os.path.splitext(os.path.basename(cfg["config"]))[0]

    # sampling output dir naming (reference utils/args.py:103-133)
    if cfg.get("model_path", ""):
        diffusion = cfg["diffusion"]
        diffusion.setdefault("timesteps_clip", diffusion["timesteps"])
        diffusion.setdefault("clip", False)
        diffusion.setdefault("dynamic_threshold", False)
        model_name = cfg["model_path"].rstrip("/").split("/")[-1].split(".")[0].split("_")[-1]
        steps = min(diffusion["sampling_timesteps"], diffusion["timesteps_clip"])
        scheduler_info = f"{diffusion['sampling_strategy']}(T={steps})"
        if diffusion["timesteps_clip"] < diffusion["timesteps"]:
            scheduler_info += f"_ts_clip{diffusion['timesteps_clip']}"
        if diffusion["clip"]:
            scheduler_info += "_clip_dynamic" if diffusion["dynamic_threshold"] else "_clip"
        if args.use_ema:
            scheduler_info += "_ema"
        cfg["out_sampling"] = os.path.join(
            os.path.dirname(cfg["model_path"]), "sampling", model_name, scheduler_info)

    output_dir = os.path.join(cfg["save_dir"], cfg["name"])
    os.makedirs(output_dir, exist_ok=True)
    cfg["output_dir"] = output_dir
    cfg.setdefault("training", {})["max_epochs"] = 1000
    return cfg


def setup_output_subdirs(output_dir: str, *subfolders: str) -> List[str]:
    """reference models/train_utils.py:209-235."""
    out = []
    for sub in subfolders:
        path = os.path.join(output_dir, sub)
        os.makedirs(path, exist_ok=True)
        out.append(path)
    return out
