"""Chamfer distance (port of p2p_bridge_tpu/metrics/chamfer.py), plain
PyTorch: the JAX package computes it with XLA, outside any Pallas kernel.

  * ``chamfer_distance``: batched fixed-shape clouds, one [B, N, M]
    distance matrix in ``pairwise_sqdist``'s matrix-product form, on the
    device of its tensors (patches, objects, the room's outlier filter).
  * ``chamfer_distance_large``: one pair of large clouds, numpy in and
    out, streamed through chunks on ``device`` (room evaluation).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.common import pairwise_sqdist
from ..ops.knn import nn_distance_chunked
from ..utils.device import resolve_device


def chamfer_distance(x: torch.Tensor, y: torch.Tensor):
    """Bidirectional nearest-neighbour squared distances.

    Args:
      x: [B, N, 3]; y: [B, M, 3].
    Returns:
      (dist_xy [B, N], dist_yx [B, M], idx_xy [B, N] int32, idx_yx [B, M]
      int32); a tie goes to the lowest index.
    """
    d2 = pairwise_sqdist(x, y)
    dist_xy, idx_xy = d2.min(dim=-1)
    dist_yx, idx_yx = d2.min(dim=-2)
    return dist_xy, dist_yx, idx_xy.int(), idx_yx.int()


def chamfer_distance_large(x: np.ndarray, y: np.ndarray, chunk: int = 8192,
                           query_chunk: int = 65536, device="cuda"):
    """Chamfer distance of one pair of large clouds (host in, host out).

    Each direction streams the target through chunks of ``chunk`` points
    against queries taken ``query_chunk`` at a time, the last of each
    ragged: the memory is O(query_chunk * chunk) whatever the sizes.
    ``device`` "cuda" with no card raises.

    Args:
      x: [N, 3]; y: [M, 3] numpy arrays.
    Returns:
      (dist_xy [N], dist_yx [M]) numpy f32 squared distances.
    """
    device = resolve_device(device)

    def one_direction(q, p):
        p_dev = torch.as_tensor(np.asarray(p, np.float32), device=device)
        return np.concatenate([
            nn_distance_chunked(torch.as_tensor(np.asarray(q[s:s + query_chunk], np.float32),
                                                device=device), p_dev, chunk)[0].cpu().numpy()
            for s in range(0, q.shape[0], query_chunk)])

    return one_direction(x, y), one_direction(y, x)
