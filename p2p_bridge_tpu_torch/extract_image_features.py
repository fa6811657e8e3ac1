"""Lift per-frame image features onto each scene's scan (port of the root
extract_image_features.py).

  python -m p2p_bridge_tpu_torch.extract_image_features --data_root <scenes> \
      [--encoder descriptor|dinov2] [--model_name DIR] [--feature_name dino] \
      [--feat_dim 384] [--suffix S] [--overwrite] [--device cuda]

The flags are those of the root CLI plus ``--device`` (default cuda), the
device of the DINOv2 forward. For each scene with
``scans/iphone<S>.ply`` and ``frames.npz`` (``images`` [F, H, W, 3] uint8,
``intrinsics`` [F, 3, 3] or one shared [3, 3], ``world_to_cam`` [F, 4, 4],
optional ``depth`` [F, H, W] for the occlusion test), the features of every
frame are projected onto the scan, averaged per point and interpolated
where no frame sees a point (``data/image_features.py``), and saved
transposed, [C, N] float16, as ``features/<feature_name>_iphone<S>.npy``:
the layout ``preprocess_batches`` and ``denoise_room`` read. The default
encoder is the built-in deterministic descriptor, not DINOv2;
``--encoder dinov2`` loads a local transformers checkpoint from
``--model_name`` onto ``--device`` and raises where there is none (nothing
is fetched). The descriptor encoder, the projection and the lifting run on
the host.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from .data.image_features import load_descriptor_extractor, load_dino_extractor, process_scene
from .utils.io import read_ply
from .utils.logging import setup_logger

logger = logging.getLogger("p2pb")


def load_frames(path: str):
    data = np.load(path)
    images = data["images"]
    intr = data["intrinsics"]
    w2c = data["world_to_cam"]
    depth = data["depth"] if "depth" in data else None
    frames = []
    for i in range(len(images)):
        frames.append({
            "image": images[i],
            "intrinsics": intr[i] if intr.ndim == 3 else intr,
            "world_to_cam": w2c[i],
            **({"depth": depth[i]} if depth is not None else {}),
        })
    return frames


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--encoder", default="descriptor", choices=["descriptor", "dinov2"])
    ap.add_argument("--model_name", default="facebook/dinov2-small")
    ap.add_argument("--feature_name", default="dino")
    ap.add_argument("--feat_dim", type=int, default=384)
    ap.add_argument("--suffix", default="")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    setup_logger()
    args = parse_args(argv)
    if args.encoder == "dinov2":
        extractor = load_dino_extractor(args.model_name, device=args.device)
    else:
        extractor = load_descriptor_extractor(args.feat_dim)

    scenes = sorted(
        s for s in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, s))
    )
    for scene in scenes:
        sdir = os.path.join(args.data_root, scene)
        ply = os.path.join(sdir, "scans", f"iphone{args.suffix}.ply")
        frames_path = os.path.join(sdir, "frames.npz")
        if not (os.path.exists(ply) and os.path.exists(frames_path)):
            logger.info("Skipping %s (no scans/iphone.ply or frames.npz)", scene)
            continue
        out_dir = os.path.join(sdir, "features")
        out = os.path.join(out_dir, f"{args.feature_name}_iphone{args.suffix}.npy")
        if os.path.exists(out) and not args.overwrite:
            logger.info("%s exists, skipping", out)
            continue
        points = read_ply(ply)["points"]
        frames = load_frames(frames_path)
        feats = process_scene(points, frames, extractor, feat_dim=args.feat_dim)
        os.makedirs(out_dir, exist_ok=True)
        # stored transposed [C, N], as the reference's extract script does;
        # preprocess_batches loads it with .T
        np.save(out, feats.T.astype(np.float16))
        logger.info("%s: %d frames -> features %s", scene, len(frames), feats.shape)


if __name__ == "__main__":
    main()
