"""3-nearest-neighbour inverse-distance interpolation (port of
p2p_bridge_tpu/ops/interpolate.py) in plain PyTorch.

Squared distances are clamped to [1e-10, 1e10]; w_i = d_j d_k /
(d0 d1 + d0 d2 + d1 d2). With fewer than 3 centres the missing slots get
index 0 and distance 1e10.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import batched_take, pairwise_sqdist


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """points [B, N, 3], centers [B, M, 3] -> (weights [B, N, 3] f32,
    indices [B, N, 3] int32)."""
    M = centers.shape[1]
    d2 = pairwise_sqdist(points, centers)
    d, idx = torch.topk(d2, min(3, M), dim=-1, largest=False, sorted=True)
    if M < 3:
        d = F.pad(d, (0, 3 - M), value=1e10)
        idx = F.pad(idx, (0, 3 - M))
    d = d.clamp(1e-10, 1e10)
    d0, d1, d2_ = d.unbind(-1)
    denom = d0 * d1 + d0 * d2_ + d1 * d2_
    w = torch.stack([d1 * d2_, d0 * d2_, d0 * d1], dim=-1) / denom[..., None]
    return w, idx.int()


def nearest_neighbor_interpolate(points: torch.Tensor, centers: torch.Tensor,
                                 features: torch.Tensor) -> torch.Tensor:
    """Fine points [B, N, 3], coarse centres [B, M, 3] and features
    [B, M, C] -> [B, N, C]."""
    w, idx = three_nn(points, centers)
    neighbors = batched_take(features, idx)  # [B, N, 3, C]
    return (neighbors * w.detach()[..., None].to(neighbors.dtype)).sum(dim=2)
