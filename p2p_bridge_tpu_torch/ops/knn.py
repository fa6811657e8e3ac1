"""k nearest neighbours (port of p2p_bridge_tpu/ops/knn.py) in plain
PyTorch, used to cut patches."""

from __future__ import annotations

import torch

from .common import pairwise_sqdist


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """query [B, M, 3], points [B, N, 3] -> (sq_dists [B, M, k] ascending,
    indices [B, M, k] int32).

    A stable sort keeps equal distances in index order, as ``lax.top_k``
    does: patch order feeds FPS (which starts at index 0) and ball query
    (first K in index order)."""
    d2 = pairwise_sqdist(query, points)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].int()
