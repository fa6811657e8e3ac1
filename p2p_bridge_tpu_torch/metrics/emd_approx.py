"""Approximate Earth Mover's Distance (port of
p2p_bridge_tpu/metrics/emd_approx.py, the Fan / Mo approxmatch).

Multi-scale soft matching in 10 fixed rounds, level = -4^j for j = 7..0,
then -0.25 and 0:

    K      = exp(level * d2)                        # [B, N, M] affinity
    ratioL = remainL / (1e-9 + K @ remainR)
    sumr   = (K^T @ ratioL) * remainR
    ratioR = min(remainR / (sumr + 1e-9), 1) * remainR
    delta  = K * ratioL[:, :, None] * ratioR[:, None, :]
    match += delta;  remainL, remainR -= marginals, clamped at 0
    cost   = sum(match * d2)

The JAX package writes it in XLA, not Pallas, so its port is plain
PyTorch on the tensors' device: two batched matrix products and
elementwise work per round, with the match kept as [B, N, M] as there.
"""

from __future__ import annotations

import torch

from ..ops.common import pairwise_sqdist

LEVELS = [-float(4.0 ** j) for j in range(7, -1, -1)] + [-0.25, 0.0]


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Soft matching of xyz1 [B, N, 3] onto xyz2 [B, M, 3] -> match
    [B, N, M] f32."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    d2 = pairwise_sqdist(xyz1, xyz2)
    # the CUDA kernel's integer-division multipliers when N != M
    multi_l = 1.0 if N >= M else float(M // N)
    multi_r = float(N // M) if N >= M else 1.0
    remain_l = torch.full((B, N), multi_l, dtype=torch.float32, device=d2.device)
    remain_r = torch.full((B, M), multi_r, dtype=torch.float32, device=d2.device)
    match = torch.zeros_like(d2)
    for level in LEVELS:
        k = torch.exp(level * d2)
        ratio_l = remain_l / (1e-9 + torch.einsum("bnm,bm->bn", k, remain_r))
        sumr = torch.einsum("bnm,bn->bm", k, ratio_l) * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        delta = k * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + delta
        remain_l = torch.clamp(remain_l - delta.sum(dim=2), min=0.0)
        remain_r = torch.clamp(remain_r - delta.sum(dim=1), min=0.0)
    return match


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """cost[b] = sum of match * d2 -> [B]."""
    return torch.sum(match * pairwise_sqdist(xyz1, xyz2), dim=(1, 2))


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate EMD of xyz1 [B, N, 3] and xyz2 [B, M, 3], divided by N
    as the reference's wrapper does -> [B]."""
    match = approx_match(xyz1, xyz2)
    return match_cost(xyz1, xyz2, match) / float(xyz1.shape[1])
