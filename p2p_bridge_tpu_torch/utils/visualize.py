"""Point-cloud figures for training monitoring (port of
``visualize_pointcloud_batch`` of p2p_bridge_tpu/utils/visualize.py):
matplotlib 3D scatter grids, clouds of more than ``max_points`` points
subsampled. matplotlib is imported when a figure is drawn, so the package
imports without it."""

from __future__ import annotations

import numpy as np


def visualize_pointcloud_batch(path: str, pointclouds, max_points: int = 10000,
                               elev: float = 30.0, azim: float = 225.0, vmin: float = -1.0,
                               vmax: float = 1.0) -> str:
    """Render clouds [B, N, 3] (or [B, 3, N], or one [N, 3]) as a grid of
    up to 4 columns into the PNG ``path``; returns ``path``. Raises
    ImportError naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualize_pointcloud_batch needs the matplotlib package") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
