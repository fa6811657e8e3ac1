"""Evaluation (port of p2p_bridge_tpu/models/evaluation.py).

  * ``evaluate``: the in-training evaluation. It samples the val loader's
    noisy patches, scores them against the clean ones (Chamfer and
    approximate EMD, x1000, and MSE) beside the noisy input's floor, logs
    the scores, and then renders the first clouds.
  * ``Evaluator``: the PU-Net / PC-Net object protocol. It scores each
    denoised shape by unit-sphere Chamfer distance and point <-> mesh
    distance. With EMD, it also scores matched 2048-point sub-samples by
    the approximate and the auction EMD (kernel K7 on the card). The means
    go into ``Summary_<dataset>.csv``.

The metrics run on an explicit ``device``; "cuda" with no card raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.batch import get_data_batch
from ..metrics import (calculate_cd, calculate_emd, calculate_emd_exact, chamfer_distance,
                       normalize_pcl, normalize_sphere, point_mesh_face_distance)
from ..utils.device import resolve_device
from ..utils.io import read_off, read_xyz
from ..utils.logging import update_summary
from ..utils.visualize import visualize_pointcloud_batch

logger = logging.getLogger("p2pb")

EMD_POINTS = 2048  # the sub-sample the EMDs of the object protocol compare


def get_metrics(pred, gt, device="cuda") -> Dict[str, float]:
    """CD and approximate EMD, both x1000, and the MSE of pred against gt
    [B, N, 3], with N cut to a multiple of 128."""
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    n = (pred.shape[1] // 128) * 128
    pred, gt = pred[:, :n], gt[:, :n]
    cd = float(np.mean(calculate_cd(pred, gt, device=device))) * 1000.0
    emd = float(np.mean(calculate_emd(pred, gt, device=device))) * 1000.0
    mse = float(np.mean((pred - gt) ** 2))
    return {"CD": cd, "EMD": emd, "MSE": mse}


@contextlib.contextmanager
def _weights(model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]]):
    """``model`` in eval mode with ``params`` (name -> tensor, as the EMA
    keeps them) in place of its own; both restored, bit for bit, after."""
    was_training = model.training
    saved = None
    with torch.no_grad():
        if params is not None:
            own = dict(model.named_parameters())
            saved = {n: p.detach().clone() for n, p in own.items()}
            for n, p in own.items():
                p.copy_(params[n])
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)
        if saved is not None:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(saved[n])


def evaluate(bridge, val_loader, cfg: dict, step: int, out_dir: Optional[str] = None,
             tracker=None, max_batches: Optional[int] = None,
             ema_params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """Sample the val loader's noisy clouds with ``bridge`` (with
    ``ema_params`` in place of the model's weights where given) and score
    them: {"eval/CD", "eval/EMD", "eval/MSE"} and the noisy input's
    {"eval/noisy_*"} floor. The scores go to the log and to ``tracker``
    before the first 8 predictions and ground truths are rendered into
    ``out_dir``: a renderer that fails loses no score.

    ``max_batches`` bounds the val batches (default
    ``training.eval_max_batches``, 4; 0 or None walks the whole set). The
    metrics run on the model's device."""
    if max_batches is None:
        max_batches = cfg.get("training", {}).get("eval_max_batches", 4)
    model = bridge.model
    device = next(model.parameters()).device
    clip = cfg["diffusion"].get("clip", False)
    preds, gts, starts = [], [], []
    with _weights(model, ema_params):
        for idx, batch in enumerate(val_loader):
            if max_batches and idx >= max_batches:
                break
            db = get_data_batch(batch, cfg)
            x_cond = None if db["x_cond"] is None else torch.from_numpy(db["x_cond"]).to(device)
            out = bridge.sample(torch.from_numpy(db["x_start"]).to(device), x_cond,
                                clip_denoise=clip)
            preds.append(out["x_pred"].float().cpu().numpy())
            gts.append(db["x_gt"])
            starts.append(db["x_start"])
    if not preds:
        return {}
    pred, gt, start = np.concatenate(preds), np.concatenate(gts), np.concatenate(starts)

    out = {f"eval/{k}": v for k, v in get_metrics(pred, gt, device).items()}
    out.update({f"eval/noisy_{k}": v for k, v in get_metrics(start, gt, device).items()})
    if tracker is not None:
        tracker.log(out, step)
    logger.info("eval @%d: %s", step, {k: round(v, 4) for k, v in out.items()})

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        png = visualize_pointcloud_batch(os.path.join(out_dir, f"{step:07d}_pred.png"), pred[:8])
        visualize_pointcloud_batch(os.path.join(out_dir, f"{step:07d}_gt.png"), gt[:8])
        if tracker is not None:
            tracker.log_image("eval/pred", png, step)
    return out


# ---------------------------------------------------------------- objects
def chamfer_distance_unit_sphere(gen, ref, device="cuda") -> float:
    """Chamfer distance (the sum of both directions' means) of gen [1, N, 3]
    and ref [1, M, 3] after normalising ref to the unit sphere and moving
    gen by the same transform."""
    device = resolve_device(device)
    ref_n, center, scale = normalize_sphere(torch.as_tensor(ref, device=device))
    gen_n = normalize_pcl(torch.as_tensor(gen, device=device), center, scale)
    d1, d2, _, _ = chamfer_distance(gen_n, ref_n)
    return float(d1.mean() + d2.mean())


def point_mesh_bidir_distance_single_unit_sphere(pcl, verts, faces, device="cuda") -> float:
    """Point -> face plus face -> point distance of pcl [N, 3] and a mesh,
    after normalising the mesh to the unit sphere and moving the cloud by
    the same transform (on the host, f32)."""
    v, center, scale = normalize_sphere(torch.as_tensor(np.asarray(verts))[None])
    p = normalize_pcl(torch.as_tensor(np.asarray(pcl))[None], center, scale)
    pd, fd = point_mesh_face_distance(p[0].numpy(), v[0].numpy(), np.asarray(faces),
                                      device=device)
    return float(pd + fd)


def load_xyz_dir(xyz_dir: str) -> Dict[str, np.ndarray]:
    out = {}
    for fn in sorted(os.listdir(xyz_dir)):
        if fn.endswith("xyz"):
            out[fn[:-4]] = read_xyz(os.path.join(xyz_dir, fn)).astype(np.float32)
    return out


def load_off_dir(off_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    out = {}
    for fn in sorted(os.listdir(off_dir)):
        if fn.endswith("off"):
            verts, faces = read_off(os.path.join(off_dir, fn))
            out[fn[:-4]] = {"verts": verts, "faces": faces}
    return out


class Evaluator:
    """The score-denoise object benchmark over one directory of outputs."""

    def __init__(self, output_pcl_dir: str, dataset_root: str, dataset: str, summary_dir: str,
                 experiment_name: str, res_gts: str = "8192_poisson", device="cuda"):
        self.output_pcl_dir = output_pcl_dir
        self.dataset = dataset
        self.summary_dir = summary_dir
        self.experiment_name = experiment_name
        self.device = resolve_device(device)
        self.gts_pcl_dir = os.path.join(dataset_root, dataset, "pointclouds", "test", res_gts)
        self.gts_mesh_dir = os.path.join(dataset_root, dataset, "meshes", "test")
        self.pcls_up = load_xyz_dir(output_pcl_dir)
        self.pcls_high = load_xyz_dir(self.gts_pcl_dir)
        self.meshes = load_off_dir(self.gts_mesh_dir)

    def run(self, with_emd: bool = True) -> Dict[str, Dict[str, float]]:
        """{shape: {"cd_sph", "p2f"[, "emd_sub", "emd_exact_sub"]}} of every
        output shape with a ground truth; the means go into the row
        ``experiment_name`` of ``<summary_dir>/Summary_<dataset>.csv``.

        With ``with_emd``, both EMDs (x1000, the auction at eps 0.001 and
        10,000 rounds) compare 2048-point sub-samples of output and ground
        truth, normalised by the ground truth's sphere. The sub-samples are
        drawn from ``np.random.default_rng(abs(hash(name)) % 2**32)``, as
        the JAX package draws them: Python salts the hash of a str per
        process unless PYTHONHASHSEED is set, so the two EMDs change from
        process to process, as the JAX package's do."""
        dev = self.device
        results = {}
        for name, pcl_up in self.pcls_up.items():
            if name not in self.pcls_high:
                logger.warning("Shape %s not found, ignored.", name)
                continue
            pcl_up3 = pcl_up[:, :3][None]
            pcl_high = self.pcls_high[name][None]
            mesh = self.meshes[name]
            results[name] = {
                "cd_sph": chamfer_distance_unit_sphere(pcl_up3, pcl_high, dev),
                "p2f": point_mesh_bidir_distance_single_unit_sphere(
                    pcl_up3[0], mesh["verts"], mesh["faces"], dev)}
            if with_emd:
                k = EMD_POINTS
                rng = np.random.default_rng(abs(hash(name)) % (2**32))
                sub_p = pcl_up3[0][rng.choice(pcl_up3.shape[1], k, replace=False)][None]
                sub_g = pcl_high[0][rng.choice(pcl_high.shape[1], k,
                                               replace=pcl_high.shape[1] < k)][None]
                ref_n, center, scale = normalize_sphere(torch.as_tensor(sub_g, device=dev))
                gen_n = normalize_pcl(torch.as_tensor(sub_p, device=dev), center, scale)
                results[name]["emd_sub"] = float(
                    np.mean(calculate_emd(gen_n, ref_n, device=dev))) * 1000.0
                results[name]["emd_exact_sub"] = float(np.mean(calculate_emd_exact(
                    gen_n, ref_n, eps=0.001, iters=10000, device=dev))) * 1000.0

        keys = ["cd_sph", "p2f"] + (["emd_sub", "emd_exact_sub"] if with_emd else [])
        mean = {k: float(np.mean([r[k] for r in results.values()])) if results else float("nan")
                for k in keys}
        for name, r in results.items():
            logger.info("%s: %s", name, {k: round(v, 8) for k, v in r.items()})
        logger.info("Mean: %s", mean)
        os.makedirs(self.summary_dir, exist_ok=True)
        update_summary(os.path.join(self.summary_dir, f"Summary_{self.dataset}.csv"),
                       model=self.experiment_name,
                       metrics={f"{k}(mean)": v for k, v in mean.items()})
        return results
