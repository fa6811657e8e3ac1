"""Shared helpers for the point ops (port of p2p_bridge_tpu/ops/common.py).

Layout as in the JAX package: coordinates ``[B, N, 3]``, features
``[B, N, C]``.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., M, N] as |a|^2 - 2 a.b + |b|^2, clamped at 0
    (one matrix product instead of an [M, N, D] difference tensor)."""
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    d2 = a2 - 2.0 * torch.matmul(a, b.transpose(-1, -2)) + b2.transpose(-1, -2)
    return d2.clamp_min(0.0)


def pairwise_sqdist_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., M, N] from per-coordinate differences,
    (dx*dx + dy*dy) + dz*dz: no cancellation, so strict radius tests agree
    with the CUDA kernels' arithmetic."""
    a = a.float()
    b = b.float()
    d2 = None
    for c in range(a.shape[-1]):
        diff = a[..., :, None, c] - b[..., None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def batched_take(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather rows per cloud: features [B, N, ...], indices [B, ...] ->
    [B, ...(indices), ...(feature trailing dims)]."""
    B = features.shape[0]
    bidx = torch.arange(B, device=features.device).view(
        B, *([1] * (indices.dim() - 1)))
    return features[bidx, indices.long()]
