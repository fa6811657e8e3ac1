"""The metrics facade (port of p2p_bridge_tpu/metrics/metrics.py): the
object metrics in sub-batches of 4 (Chamfer, approximate EMD, auction
EMD), unit-sphere normalisation, Chamfer after it, point <-> mesh
distance, and the room-scale Chamfer pair. Each takes [B, N, 3] clouds
(numpy or torch) and an explicit ``device``: "cuda" with no card raises."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .chamfer import chamfer_distance, chamfer_distance_large
from .emd_approx import earth_mover_distance
from .emd_auction import auction_emd
from .p2m import point_mesh_face_distance


def _bnc(x, device) -> torch.Tensor:
    """x as an f32 tensor [B, N, 3] on ``device``; [B, 3, N] is
    transposed, as the JAX facade tolerates it."""
    x = torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))
    if x.shape[-1] != 3:
        x = x.transpose(-1, -2)
    return x


def calculate_cd(pred, gt, device="cuda") -> List[float]:
    """Per-cloud symmetric Chamfer distance: mean(d_pg) + mean(d_gp)."""
    pred, gt = _bnc(pred, device), _bnc(gt, device)
    dl, dr, _, _ = chamfer_distance(pred, gt)
    return [float(v) for v in (dl.mean(dim=1) + dr.mean(dim=1)).cpu()]


calculate_cd_cuda = calculate_cd  # the reference's name


def calculate_emd(pred, gt, device="cuda") -> List[float]:
    """Approximate EMD, one mean per sub-batch of 4 clouds."""
    pred, gt = _bnc(pred, device), _bnc(gt, device)
    return [float(earth_mover_distance(pred[s:s + 4], gt[s:s + 4]).mean())
            for s in range(0, pred.shape[0], 4)]


calculate_emd_cuda = calculate_emd


def calculate_emd_exact(pred, gt, eps: float = 0.001, iters: int = 10000,
                        device="cuda") -> List[float]:
    """Auction EMD, sqrt of the mean matched squared distance per cloud,
    in sub-batches of 4 (kernel K7 on the card)."""
    pred, gt = _bnc(pred, device), _bnc(gt, device)
    out = []
    for s in range(0, pred.shape[0], 4):
        dist, _ = auction_emd(pred[s:s + 4], gt[s:s + 4], eps=eps, iters=iters)
        out.extend(float(v) for v in dist.mean(dim=1).sqrt().cpu())
    return out


calculate_emd_exact_cuda = calculate_emd_exact


def normalize_sphere(pc, radius: float = 1.0):
    """Bounding-box centre and max-norm scale to the sphere of ``radius``.

    pc: [B, N, 3] -> (normalised, center [B, 1, 3], scale [B, 1, 1])."""
    pc = torch.as_tensor(pc, dtype=torch.float32)
    center = (pc.amax(dim=-2, keepdim=True) + pc.amin(dim=-2, keepdim=True)) / 2
    pc = pc - center
    scale = torch.sqrt(torch.sum(pc**2, dim=-1, keepdim=True)).amax(dim=-2, keepdim=True) / radius
    return pc / scale, center, scale


def normalize_pcl(pc, center, scale):
    return (pc - center) / scale


def cd_unit_sphere(gen, ref, normalize: bool = True, device="cuda") -> Tuple[float, float]:
    """Chamfer distance (means of both directions' squared distances) after
    normalising REF to the unit sphere and moving GEN by the same
    transform, on ``device`` ("cuda" with no card raises)."""
    gen, ref = _bnc(gen, device), _bnc(ref, device)
    if normalize:
        ref, center, scale = normalize_sphere(ref)
        gen = normalize_pcl(gen, center, scale)
    cd1, cd2, _, _ = chamfer_distance(gen, ref)
    return float(cd1.mean()), float(cd2.mean())


def point_face_dist(pcl, verts, faces, normalize: bool = True,
                    device="cuda") -> Tuple[float, float]:
    """Point <-> mesh distance after normalising the mesh to the unit
    sphere and moving the cloud by the same transform (on the host, f32);
    the candidate distances run on ``device``."""
    pcl = np.asarray(pcl, np.float32)
    verts = np.asarray(verts, np.float32)
    if normalize:
        v, center, scale = normalize_sphere(torch.from_numpy(verts[None]))
        verts = v[0].numpy()
        pcl = normalize_pcl(torch.from_numpy(pcl[None]), center, scale)[0].numpy()
    return point_mesh_face_distance(pcl, verts, np.asarray(faces), device=device)


def cd_large_pair(pred: np.ndarray, gt: np.ndarray, device="cuda") -> Tuple[float, float]:
    """Room-scale Chamfer distance, both directions (means of squared
    nearest-neighbour distances), for evaluate_rooms."""
    d_pg, d_gp = chamfer_distance_large(pred, gt, device=device)
    return float(d_pg.mean()), float(d_gp.mean())
