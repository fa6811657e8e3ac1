"""Denoise one room scan with the PyTorch port.

  python -m p2p_bridge_tpu_torch.denoise_room --room_path scene/scans/iphone.ply \
      --model_path runs/PVDL_SNPP [--device cuda]

The flags are those of the root denoise_room.py, plus ``--device``
(default ``cuda``; with no card it raises unless ``--device cpu``).
``--model_path`` and the configuration are read as
``denoise_object`` reads them (``models.model_loader.load_config`` /
``load_weights``); the backbone computes in the configuration's dtype
(bf16 for the shipped PVDL_SNPP). With ``data.point_features: dino`` the
features are ``<scene>/features/<feature_name>.npy``, [C, N] for ScanNet++
(transposed on load) and [N, C] for ARKitScenes. The prediction goes to
``--out_path`` or ``<scene>/predictions/P2SB/<run>_<scan>_<steps of
training>_<steps><_ema>.ply``, as the root CLI names it.

``--shard_patches`` shards each patch batch over the ranks of a torchrun
launch, one process a card (NCCL; gloo on the CPU):

  torchrun --nproc_per_node N -m p2p_bridge_tpu_torch.denoise_room \
      --room_path ... --model_path ... --shard_patches

Every rank builds the same patches, samples its ``batch_size / N`` rows of
each batch on ``cuda:LOCAL_RANK`` (or ``--device``) and gathers the
others'; rank 0 alone writes the prediction. ``--batch_size`` must divide
by N.

``--profile_dir DIR`` traces the room with ``torch.profiler`` (rank 0's)
into ``DIR/trace_room.json``, written after the prediction: the room
engine's spans (``rooms.seed``, ``rooms.patches``, ``rooms.split_fps``,
``rooms.batches``, ``rooms.upload``) and ``sampler.step`` beside the
kernels and copies they launched.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .models.model_loader import load_config, load_weights
from .models.p2pb import P2PBridge
from .models.unet_pvc import build_unet_from_config, compute_dtype
from .parallel.mesh import initialize_distributed, make_data_mesh
from .rooms import denoise_room
from .utils.device import profiler, resolve_device
from .utils.io import load_point_cloud, write_ply

logger = logging.getLogger("p2pb")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--room_path", type=str, required=True, help="Path to the room point cloud.")
    parser.add_argument("--model_path", type=str, required=True,
                        help="Path to the model: a run directory, its model.pt, or a JAX checkpoint "
                             "exported by export_jax_checkpoint.py (.npz).")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--use_ema", type=bool, default=True)
    parser.add_argument("--feature_name", type=str, default="dino_iphone")
    parser.add_argument("--out_path", type=str, default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--average_predictions", type=bool, default=True)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--k", type=int, default=4, help="Patch oversampling factor.")
    parser.add_argument("--intermediate", action="store_true")
    parser.add_argument("--filter_outliers", action="store_true",
                        help="Drop the 1%% per-patch outliers vs the input "
                             "patch before averaging.")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--shard_patches", action="store_true",
                        help="Shard each patch batch over the ranks of a torchrun launch.")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--gpu", type=str, default="", help="(accepted for CLI parity; see --device)")
    parser.add_argument("--distribution_type", default="none")
    parser.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu.")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Trace the room with torch.profiler into DIR/trace_room.json.")
    return parser.parse_known_args(argv)


def load_room_files(room_path: str, feature_name: str, data_cfg: dict):
    """(points [N, 3] f64, colors or None, features [N, C] or None)."""
    data = load_point_cloud(room_path)
    room_points = data["points"].astype(np.float64)
    room_colors = data.get("colors")
    if room_colors is not None and len(room_colors) != len(room_points):
        logger.warning("Color array length mismatch; dropping colors.")
        room_colors = None

    room_feat = None
    if data_cfg.get("point_features") == "dino":
        feat_path = os.path.join(os.path.dirname(room_path), "..", "features",
                                 f"{feature_name}.npy")
        try:
            room_feat = np.load(feat_path)
        except OSError:
            logger.warning("No dino features found at %s", feat_path)
        else:
            if "arkit" not in data_cfg["dataset"].lower():
                room_feat = room_feat.T
    return room_points, room_colors, room_feat


def output_path(args) -> str:
    """--out_path, or the root CLI's name for the prediction."""
    if args.out_path:
        return os.path.abspath(args.out_path)
    model_path = args.model_path.rstrip("/")
    training_steps = model_path.split("_")[-1].split(".")[0]
    model_config = model_path.split("/")[-2] if "/" in model_path else "model"
    ema = "_ema" if args.use_ema else ""
    room_source = os.path.basename(args.room_path).split(".")[0]
    return os.path.join(
        os.path.dirname(args.room_path), "..", "predictions", "P2SB",
        f"{model_config.replace('_', '-')}_{room_source.replace('_', '-')}_"
        f"{training_steps}_{args.steps}{ema}.ply")


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args, overrides = parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.shard_patches:
        initialize_distributed(device=device)
        mesh = make_data_mesh(device)
        device = mesh.device
    try:
        return _denoise(args, overrides, device, mesh)
    finally:
        if mesh is not None and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _denoise(args, overrides, device, mesh) -> str:
    np.random.seed(args.seed)
    out_path = output_path(args)
    if os.path.exists(out_path) and not args.overwrite:
        logger.info("Prediction already exists at %s", out_path)
        return out_path

    cfg = load_config(args.model_path, overrides)
    logger.info("computing in %s", compute_dtype(cfg))
    torch.manual_seed(args.seed)
    model = build_unet_from_config(cfg)
    load_weights(model, args.model_path, args.use_ema)
    bridge = P2PBridge.from_config(cfg, model.to(device).eval())

    room_points, room_colors, room_feat = load_room_files(args.room_path, args.feature_name,
                                                          cfg["data"])
    query_radius = 0.3 if "scannet" in cfg["data"]["dataset"].lower() else 0.5
    logger.info("Detected dataset: %s, denoising in radius %.1f",
                cfg["data"]["dataset"], query_radius)

    prof = None
    if args.profile_dir and (mesh is None or mesh.is_main):
        prof = profiler(device)
        prof.start()
    try:
        out = denoise_room(
            bridge,
            np.asarray(room_points, np.float32),
            steps=args.steps,
            k=args.k,
            patch_size=cfg["data"]["npoints"],
            batch_size=args.batch_size,
            query_radius=query_radius,
            room_colors=room_colors,
            room_features=room_feat,
            use_rgb=cfg["data"].get("use_rgb_features", False),
            use_feat=cfg["data"].get("point_features") == "dino" and room_feat is not None,
            average_predictions=args.average_predictions,
            filter_outliers=args.filter_outliers,
            return_steps=args.intermediate,
            seed=args.seed,
            mesh=mesh,
        )
    finally:
        if prof is not None:
            prof.stop()
    if mesh is not None and not mesh.is_main:
        return out_path

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_ply(out_path, out["denoised"], colors=room_colors)
    logger.info("Wrote %s", out_path)
    if "steps" in out:
        for i, step_cloud in enumerate(out["steps"]):
            write_ply(f"{out_path.rsplit('.', 1)[0]}_step_{i}.ply", step_cloud,
                      colors=room_colors)
    if prof is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace_room.json")
        prof.export_chrome_trace(trace)
        logger.info("Wrote profiler trace to %s", trace)
    return out_path


if __name__ == "__main__":
    main()
