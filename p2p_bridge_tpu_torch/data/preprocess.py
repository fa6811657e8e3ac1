"""Offline data preprocessing: paired spherical training batches (copy of
p2p_bridge_tpu/data/preprocess.py on the port's host runtime and PLY
reader; tests hold the two equal, file for file).

Port of the reference's preprocessing pipeline
(reference: data/processing/utils.py:12-226 + data/preprocess_batches.py:15-91):
pairs a clean (Faro mesh) scan with a noisy (iPhone) scan per scene by

  * uniformly oversampling the clean mesh surface (x5 the noisy count),
  * bucket-FPS seed centers over the noisy cloud,
  * KD-tree radius neighborhoods from both clouds,
  * pad-with-jittered-duplicates / FPS-downsample the noisy side to
    exactly ``npoints``,
  * greedy unique nearest-neighbor ASSIGNMENT of clean points onto the
    noisy points (k=128 candidates; cuML kNN -> scipy cKDTree),
  * per-batch center/scale normalization,
  * save clean/noisy (+rgb), optional fp16 features, idxs, center, scale.

Everything runs on the host in numpy + the native runtime (no GPU deps).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
from scipy.spatial import cKDTree

from ..runtime import bucket_fps_host, fps_host

logger = logging.getLogger("p2pb")


def optimize_assignments(
    A: np.ndarray, B: np.ndarray, closest_neighbors: np.ndarray
) -> np.ndarray:
    """Greedy unique assignment A->B (reference processing/utils.py:12-40):
    each point takes its nearest still-available candidate; falls back to
    the overall nearest when all k candidates are taken."""
    N = A.shape[0]
    assigned = -1 * np.ones(N, dtype=np.int64)
    available = np.ones(B.shape[0], dtype=bool)
    for i, neigh in enumerate(closest_neighbors):
        for n in neigh:
            if available[n]:
                assigned[i] = n
                available[n] = False
                break
        if assigned[i] == -1:
            assigned[i] = neigh[0]
    return assigned


def find_closest_neighbors(A: np.ndarray, B: np.ndarray, k: int = 5) -> np.ndarray:
    """k nearest points in B for each point of A (cuML kNN replacement,
    reference processing/utils.py:43-60)."""
    tree = cKDTree(B)
    _, idx = tree.query(A, k=min(k, len(B)), workers=-1)
    return idx.reshape(len(A), -1)


def sample_mesh_uniform(
    verts: np.ndarray, faces: np.ndarray, n: int,
    vert_colors: Optional[np.ndarray] = None, seed: int = 0,
):
    """Uniform surface sampling (open3d sample_points_uniformly
    replacement, reference data/preprocess_batches.py:60-62).

    Returns (points [n, 3], colors [n, 3] or None)."""
    rng = np.random.default_rng(seed)
    tris = verts[faces]  # [F, 3, 3]
    areas = 0.5 * np.linalg.norm(
        np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=1
    )
    probs = areas / areas.sum()
    face_idx = rng.choice(len(faces), size=n, p=probs)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    w = 1 - u - v
    bary = np.stack([w, u, v], axis=1)  # [n, 3]
    pts = np.einsum("nk,nkd->nd", bary, tris[face_idx])
    colors = None
    if vert_colors is not None:
        colors = np.einsum("nk,nkd->nd", bary, vert_colors[faces][face_idx])
    return pts.astype(np.float32), colors


def create_spherical_batches(
    pcd_clean: np.ndarray,
    pcd_noisy: np.ndarray,
    rgb_clean: Optional[np.ndarray],
    rgb_noisy: Optional[np.ndarray],
    features: Optional[np.ndarray],
    npoints: int = 4096,
    radius: float = 0.3,
    assignment_k: int = 128,
    seed: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """The pairing algorithm (reference processing/utils.py:64-226)."""
    rng = np.random.default_rng(seed)
    if rgb_clean is None:
        rgb_clean = np.zeros_like(pcd_clean)
    if rgb_noisy is None:
        rgb_noisy = np.zeros_like(pcd_noisy)
    tree_clean = cKDTree(pcd_clean)
    tree_noisy = cKDTree(pcd_noisy)

    n_batches = int(np.ceil(pcd_noisy.shape[0] / npoints))
    centers = pcd_noisy[bucket_fps_host(pcd_noisy.astype(np.float32), n_batches)]
    idxs_clean = tree_clean.query_ball_point(centers, r=radius, workers=-1)
    idxs_noisy = tree_noisy.query_ball_point(centers, r=radius, workers=-1)

    data = []
    n_skipped = 0
    unique_assignments = 0.0
    for bi in range(n_batches):
        ic = np.asarray(idxs_clean[bi], np.int64)
        inz = np.asarray(idxs_noisy[bi], np.int64)
        clean_pts = pcd_clean[ic]
        noisy_pts = pcd_noisy[inz]
        clean_rgb = rgb_clean[ic]
        noisy_rgb = rgb_noisy[inz]
        noisy_feat = features[inz] if features is not None else None

        # skip small batches (processing/utils.py:118-125)
        if len(clean_pts) < npoints or len(noisy_pts) < npoints // 8:
            n_skipped += 1
            continue

        diff = npoints - len(noisy_pts)
        if diff > 0:
            ridx = rng.integers(0, len(noisy_pts), diff)
            extra = noisy_pts[ridx]
            diag = np.linalg.norm(noisy_pts.max(0) - noisy_pts.min(0))
            extra = extra + rng.normal(0, 1e-2 * diag, extra.shape)
            noisy_pts = np.concatenate([noisy_pts, extra])
            noisy_rgb = np.concatenate([noisy_rgb, noisy_rgb[ridx]])
            if noisy_feat is not None:
                noisy_feat = np.concatenate([noisy_feat, noisy_feat[ridx]])
            out_idxs = np.concatenate([inz, inz[ridx]])
        else:
            fps_idx = fps_host(noisy_pts.astype(np.float32), npoints)
            noisy_pts = noisy_pts[fps_idx]
            noisy_rgb = noisy_rgb[fps_idx]
            if noisy_feat is not None:
                noisy_feat = noisy_feat[fps_idx]
            out_idxs = inz[fps_idx]

        cn = find_closest_neighbors(noisy_pts, clean_pts, k=assignment_k)
        assignment = optimize_assignments(noisy_pts, clean_pts, cn)
        unique_assignments += len(np.unique(assignment)) / len(assignment)
        clean_aligned = clean_pts[assignment]
        clean_rgb_aligned = clean_rgb[assignment]

        center = noisy_pts.mean(axis=0)
        clean_aligned = clean_aligned - center
        noisy_pts = noisy_pts - center
        scale = np.linalg.norm(noisy_pts, axis=1).max()
        clean_aligned = clean_aligned / scale
        noisy_pts = noisy_pts / scale

        batch = {
            "clean": np.concatenate([clean_aligned, clean_rgb_aligned], 1).astype(np.float32),
            "noisy": np.concatenate([noisy_pts, noisy_rgb], 1).astype(np.float32),
            "idxs": out_idxs,
            "center": center.astype(np.float32),
            "scale": np.float32(scale),
        }
        if noisy_feat is not None:
            batch["features"] = noisy_feat.astype(np.float16)
        data.append(batch)

    logger.info("Skipped %d of %d batches", n_skipped, n_batches)
    if data:
        logger.info("Unique assignments: %.3f", unique_assignments / len(data))
    return data


def preprocess_scene(
    scene_dir: str,
    output_dir: str,
    npoints: int = 4096,
    radius: float = 0.3,
    name_suffix: str = "",
    feature_type: Optional[str] = None,
    oversample: int = 5,
    seed: int = 0,
) -> int:
    """One scene: load faro mesh + iphone cloud, oversample mesh,
    create batches, save points_i.npz (reference preprocess_batches.py:15-91).

    Returns the number of batches written."""
    from ..utils.io import read_ply

    faro_path = os.path.join(scene_dir, "scans", "mesh_aligned_0.05.ply")
    iphone_path = os.path.join(scene_dir, "scans", f"iphone{name_suffix}.ply")
    if not (os.path.exists(faro_path) and os.path.exists(iphone_path)):
        logger.info("Skipping %s (missing scans)", scene_dir)
        return 0

    features = None
    if feature_type is not None:
        fpath = os.path.join(
            scene_dir, "features", f"{feature_type}_iphone{name_suffix}.npy"
        )
        if not os.path.exists(fpath):
            logger.info("Skipping %s (missing features)", scene_dir)
            return 0
        features = np.load(fpath).T

    iphone = read_ply(iphone_path)
    faro = read_ply(faro_path)
    xyz_iphone = iphone["points"]
    rgb_iphone = iphone.get("colors")
    if features is not None and features.shape[0] != len(xyz_iphone):
        logger.info("Skipping %s (feature/point count mismatch)", scene_dir)
        return 0

    if "faces" in faro:
        xyz_faro, rgb_faro = sample_mesh_uniform(
            faro["points"], faro["faces"], len(xyz_iphone) * oversample,
            vert_colors=faro.get("colors"), seed=seed,
        )
    else:
        xyz_faro, rgb_faro = faro["points"], faro.get("colors")

    batches = create_spherical_batches(
        xyz_faro, xyz_iphone, rgb_faro, rgb_iphone, features,
        npoints=npoints, radius=radius, seed=seed,
    )
    os.makedirs(output_dir, exist_ok=True)
    for i, batch in enumerate(batches):
        np.savez(os.path.join(output_dir, f"points_{i}.npz"), **batch)
    return len(batches)
