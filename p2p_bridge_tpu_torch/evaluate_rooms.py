"""Room metrics of the PyTorch port: Chamfer distance both ways and, for
ScanNet++, point <-> mesh distance against the ground-truth mesh, x 10^3.

  python -m p2p_bridge_tpu_torch.evaluate_rooms --data_root <root> --dataset snpp \
      [--normalize] [--suffix S] [--device cuda]

The flags are those of the root evaluate_rooms.py, plus ``--device``
(default ``cuda``; with no card it raises unless ``--device cpu``). Layout
of a scene under ``--data_root``: ``scans/iphone<S>.ply`` (the scan),
``scans/mesh_aligned_0.05.ply`` (ScanNet++) or ``scans/faro.ply``
(ARKitScenes), and ``predictions<S>/<model>/*.ply|*.xyz``. Each model's
metrics go to ``<model>/metrics<S>.csv`` (with ``--normalize``
``metrics<S>.csv_normalized.csv``), one row per prediction with the columns
model_config, point_dist, face_dist, cd_pred_gt, cd_gt_pred; a prediction
already named in ``metrics<S>.csv`` is skipped, as in the root CLI.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
from typing import Dict, Optional

import numpy as np

from .metrics.metrics import cd_large_pair, cd_unit_sphere, point_face_dist
from .ops.fps import bucket_fps
from .utils.device import resolve_device
from .utils.io import load_point_cloud, read_ply

logger = logging.getLogger("p2pb")

MULTIPLIER = 10**3
COLUMNS = ["model_config", "point_dist", "face_dist", "cd_pred_gt", "cd_gt_pred"]


def get_metrics(args, gt: np.ndarray, pred: np.ndarray, gt_mesh=None) -> Dict:
    """Chamfer both ways and point/face distance of one prediction."""
    data: Dict[str, Optional[float]] = {}
    if args.dataset == "snpp":
        if gt_mesh is None:
            raise ValueError("Ground truth mesh is required for SNPP dataset")
        point_dist, face_dist = point_face_dist(
            pred, gt_mesh["points"], gt_mesh["faces"], normalize=args.normalize,
            device=args.device)
        data["point_dist"] = point_dist * MULTIPLIER
        data["face_dist"] = face_dist * MULTIPLIER
    else:
        data["point_dist"] = None
        data["face_dist"] = None

    if args.normalize:
        cd_pred_gt, cd_gt_pred = cd_unit_sphere(pred[None], gt[None], normalize=True,
                                                device=args.device)
    else:
        # full-size clouds: the chunked large-pair path
        cd_pred_gt, cd_gt_pred = cd_large_pair(
            np.asarray(pred, np.float32), np.asarray(gt, np.float32), device=args.device)
    data["cd_pred_gt"] = cd_pred_gt * MULTIPLIER
    data["cd_gt_pred"] = cd_gt_pred * MULTIPLIER
    return data


def read_rows(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_folder(root: str, args) -> Optional[Dict]:
    """The scan, the ground truth and each model's predictions still to
    evaluate of one scene folder."""
    scans = os.path.join(root, "scans")
    iphone = os.path.join(scans, f"iphone{args.suffix}.ply")
    faro_file = (os.path.join(scans, "mesh_aligned_0.05.ply") if args.dataset == "snpp"
                 else os.path.join(scans, "faro.ply"))
    predictions = os.path.join(root, f"predictions{args.suffix}")
    if not os.path.exists(predictions):
        logger.warning("No predictions found in %s", root)
        return None

    models = [os.path.join(predictions, m) for m in os.listdir(predictions)
              if m not in ("iphone", "gt", "tsdf")]
    data = {"iphone": None, "faro": None, "faro_mesh": None, "models": {}}
    iphone_pcd = load_point_cloud(iphone)["points"]

    for model in models:
        preds = [os.path.join(model, f) for f in os.listdir(model)
                 if f.endswith(".ply") or f.endswith(".xyz")]
        data["models"][model] = {}
        csv_path = os.path.join(model, f"metrics{args.suffix}.csv")
        done = []
        if os.path.exists(csv_path):
            done = [r["model_config"] for r in read_rows(csv_path) if r.get("model_config")]
        for pred in preds:
            name = os.path.basename(pred)[:-4]
            if name in done:
                logger.info("Metrics for %s/%s already calculated", model, name)
                continue
            pred_pcd = load_point_cloud(pred)["points"]
            if args.dataset == "snpp":
                if iphone_pcd.shape[0] < pred_pcd.shape[0]:
                    logger.warning("Downsampling %s %s (point count mismatch)", model, name)
                    pred_pcd = pred_pcd[bucket_fps(pred_pcd, iphone_pcd.shape[0])]
                elif iphone_pcd.shape[0] > pred_pcd.shape[0]:
                    logger.warning("Skipping %s %s (point count mismatch)", model, name)
                    continue
            data["models"][model][name] = pred_pcd

    mesh = read_ply(faro_file)
    data["iphone"] = iphone_pcd
    data["faro"] = mesh["points"]
    data["faro_mesh"] = mesh if "faces" in mesh else None
    logger.info("Loaded data from %s", root)
    return data


def handle_scene(scene_folder: str, args) -> None:
    data = load_folder(scene_folder, args)
    if data is None:
        return
    for model, model_data in data["models"].items():
        csv_name = f"metrics{args.suffix}.csv"
        if args.normalize:
            csv_name += "_normalized.csv"
        metrics_path = os.path.join(model, csv_name)

        rows = []
        for name, pred in model_data.items():
            logger.info("Calculating metrics for %s / %s", model, name)
            m = get_metrics(args, data["faro"], pred, gt_mesh=data["faro_mesh"])
            m["model_config"] = name
            logger.info("%s", m)
            rows.append(m)
        if not rows:
            continue
        old = read_rows(metrics_path) if os.path.exists(metrics_path) else []
        columns = list(old[0].keys()) if old else COLUMNS
        with open(metrics_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns)
            writer.writeheader()
            writer.writerows(old + rows)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dataset", type=str, required=True, choices=["snpp", "arkit"])
    parser.add_argument("--single_dir", action="store_true")
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--suffix", default="")
    parser.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu.")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    resolve_device(args.device)
    for scene in sorted(os.listdir(args.data_root)):
        handle_scene(os.path.join(args.data_root, scene), args)


if __name__ == "__main__":
    main()
