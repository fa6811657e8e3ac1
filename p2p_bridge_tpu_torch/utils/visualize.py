"""Point-cloud figures for training monitoring (port of
``visualize_pointcloud_batch`` and ``visualize_voxels`` of
p2p_bridge_tpu/utils/visualize.py): matplotlib 3D scatter grids, clouds of
more than ``max_points`` points subsampled, and voxel occupancy grids.
matplotlib is imported when a figure is drawn, so the package imports
without it."""

from __future__ import annotations

import numpy as np


def _pyplot(what: str):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what} needs the matplotlib package") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_pointcloud_batch(path: str, pointclouds, max_points: int = 10000,
                               elev: float = 30.0, azim: float = 225.0, vmin: float = -1.0,
                               vmax: float = 1.0) -> str:
    """Render clouds [B, N, 3] (or [B, 3, N], or one [N, 3]) as a grid of
    up to 4 columns into the PNG ``path``; returns ``path``. Raises
    ImportError naming matplotlib where it is not installed."""
    plt = _pyplot("visualize_pointcloud_batch")
    pointclouds = np.asarray(pointclouds)
    if pointclouds.ndim == 2:
        pointclouds = pointclouds[None]
    if pointclouds.shape[-1] != 3:
        pointclouds = np.swapaxes(pointclouds, -1, -2)
    B = len(pointclouds)
    cols = min(B, 4)
    rows = (B + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    rng = np.random.default_rng(0)
    for i, pc in enumerate(pointclouds):
        if pc.shape[0] > max_points:
            pc = pc[rng.choice(pc.shape[0], max_points, replace=False)]
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 2], pc[:, 1], s=0.5, c=pc[:, 2], cmap="viridis")
        ax.view_init(elev=elev, azim=azim)
        ax.set_xlim(vmin, vmax)
        ax.set_ylim(vmin, vmax)
        ax.set_zlim(vmin, vmax)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(path, dpi=100)
    plt.close(fig)
    return path


def visualize_voxels(out_file: str, voxels, num_shown: int = 16, threshold: float = 0.5) -> str:
    """Render voxel grids [B, r, r, r] (or [B, 1, r, r, r], or [B, r, r, r,
    C] of which channel 0 is drawn), each value above ``threshold``
    occupied, as a grid of the first ``num_shown`` into ``out_file``;
    returns ``out_file``. Raises ImportError naming matplotlib where it is
    not installed."""
    plt = _pyplot("visualize_voxels")
    voxels = np.asarray(voxels)
    if voxels.ndim == 5:
        voxels = voxels[:, 0] if voxels.shape[1] == 1 else voxels[..., 0]
    occ = voxels > threshold
    num_shown = min(num_shown, occ.shape[0])
    n = max(int(np.sqrt(num_shown)), 1)
    fig = plt.figure(figsize=(20, 20))
    for idx in range(min(num_shown, n * n)):
        ax = fig.add_subplot(n, n, idx + 1, projection="3d")
        ax.voxels(occ[idx], edgecolor="k", facecolors="green", linewidth=0.1, alpha=0.5)
        ax.view_init()
        ax.axis("off")
    plt.savefig(out_file, bbox_inches="tight")
    plt.close(fig)
    return out_file
