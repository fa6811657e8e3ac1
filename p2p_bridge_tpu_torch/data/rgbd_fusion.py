"""RGB-D frame fusion: back-project depth frames into a fused colored
point cloud (copy of p2p_bridge_tpu/data/rgbd_fusion.py; tests hold the
two equal).

Numpy replacement for the live part of the reference's vendored
ScanNet++ iPhone toolkit (reference: data/scannetpp/iphone/
process_dataset.py:20-137 and arkit_pcl.py:36+, which produce
``iphone.ply`` from posed RGB-D frames via open3d). Everything here is
dependency-free numpy; voxel downsampling replaces open3d's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def backproject_depth(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    cam_to_world: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    depth_scale: float = 1000.0,
    depth_trunc: float = 10.0,
    stride: int = 1,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One frame -> world-space points (+ colors).

    Args:
      depth: [H, W] uint16/float depth image.
      intrinsics: [3, 3] K.
      cam_to_world: [4, 4] pose.
      rgb: optional [H, W, 3] uint8 image (may be higher-res; sampled
        proportionally).
      depth_scale: raw-to-meters divisor for integer depth.
      depth_trunc: drop depths beyond this (meters).
      stride: subsample pixels.
    Returns:
      (points [N, 3] float32, colors [N, 3] float32 in [0,1] or None)
    """
    d = depth.astype(np.float32)
    if depth.dtype != np.float32 and depth.dtype != np.float64:
        d = d / depth_scale
    H, W = d.shape
    vs, us = np.meshgrid(
        np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij"
    )
    z = d[vs, us]
    valid = (z > 0) & (z < depth_trunc)
    us, vs, z = us[valid], vs[valid], z[valid]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (us - cx) / fx * z
    y = (vs - cy) / fy * z
    cam = np.stack([x, y, z, np.ones_like(z)], axis=1)
    world = (cam_to_world @ cam.T).T[:, :3].astype(np.float32)

    colors = None
    if rgb is not None:
        sy = rgb.shape[0] / H
        sx = rgb.shape[1] / W
        cv = (vs * sy).astype(np.int64).clip(0, rgb.shape[0] - 1)
        cu = (us * sx).astype(np.int64).clip(0, rgb.shape[1] - 1)
        colors = rgb[cv, cu].astype(np.float32)
        if colors.max() > 1.0:
            colors = colors / 255.0
    return world, colors


def voxel_downsample(
    points: np.ndarray, voxel_size: float, colors: Optional[np.ndarray] = None
):
    """Average points (and colors) within voxels (open3d
    voxel_down_sample replacement)."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    # unique voxel ids via lexicographic ordering
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    n_vox = inverse.max() + 1
    sums = np.zeros((n_vox, 3), np.float64)
    cnts = np.zeros(n_vox, np.int64)
    np.add.at(sums, inverse, points)
    np.add.at(cnts, inverse, 1)
    out = (sums / cnts[:, None]).astype(np.float32)
    out_colors = None
    if colors is not None:
        csum = np.zeros((n_vox, colors.shape[1]), np.float64)
        np.add.at(csum, inverse, colors)
        out_colors = (csum / cnts[:, None]).astype(np.float32)
    return out, out_colors


def fuse_rgbd_frames(
    frames: List[Dict],
    voxel_size: float = 0.01,
    depth_trunc: float = 10.0,
    stride: int = 1,
) -> Dict[str, np.ndarray]:
    """Fuse posed RGB-D frames into one downsampled colored cloud
    (reference iphone/process_dataset.py:20-137).

    Args:
      frames: dicts with "depth" [H, W], "intrinsics" [3, 3],
        "cam_to_world" [4, 4], optional "rgb" [H', W', 3].
    Returns:
      {"points": [N, 3], "colors": [N, 3] or absent}
    """
    all_pts, all_cols = [], []
    has_color = all("rgb" in f for f in frames)
    for f in frames:
        pts, cols = backproject_depth(
            f["depth"], f["intrinsics"], f["cam_to_world"],
            rgb=f.get("rgb") if has_color else None,
            depth_trunc=depth_trunc, stride=stride,
        )
        all_pts.append(pts)
        if has_color:
            all_cols.append(cols)
    points = np.concatenate(all_pts)
    colors = np.concatenate(all_cols) if has_color else None
    points, colors = voxel_downsample(points, voxel_size, colors)
    out = {"points": points}
    if colors is not None:
        out["colors"] = colors
    return out
