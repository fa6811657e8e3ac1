"""k nearest neighbours (port of p2p_bridge_tpu/ops/knn.py) in plain
PyTorch: ``knn`` cuts patches, ``nn_distance_chunked`` is the chunked
nearest-neighbour search of the room-scale Chamfer distance."""

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


def nn_distance_chunked(query: torch.Tensor, points: torch.Tensor, chunk: int = 4096):
    """1-NN squared distance of every query point to a large point set, on
    the query's device.

    ``points`` streams through in chunks of ``chunk`` rows (the last one
    ragged), so the [M, N] distance matrix never exists, only [M, chunk].
    Distances take :func:`pairwise_sqdist`'s form; an earlier chunk keeps
    a tie, and within a chunk the lowest index wins, as in the JAX
    package's scan (which pads N to a multiple of ``chunk`` instead).

    Args:
      query: [M, 3]; points: [N, 3].
    Returns:
      (sq_dists [M] f32, indices [M] int32)
    """
    M, N = query.shape[0], points.shape[0]
    best_d = torch.full((M,), float("inf"), dtype=torch.float32, device=query.device)
    best_i = torch.zeros((M,), dtype=torch.int32, device=query.device)
    for offset in range(0, N, chunk):
        d_min, i_min = pairwise_sqdist(query, points[offset:offset + chunk]).min(dim=-1)
        take = d_min < best_d
        best_d = torch.where(take, d_min, best_d)
        best_i = torch.where(take, i_min.int() + offset, best_i)
    return best_d, best_i
