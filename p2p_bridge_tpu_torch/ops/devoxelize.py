"""Trilinear devoxelization (port of p2p_bridge_tpu/ops/devoxelize.py) in
plain PyTorch. In f32 the JAX package computes it outside Pallas too; the
devoxelize kernel belongs to the bf16 slice.

CUDA corner rule: per axis the low corner is floor(c) with weight 1 - frac,
and the high corner steps to floor(c) + 1 only when frac > 0 (weight frac).
"""

from __future__ import annotations

import torch


def trilinear_devoxelize(grid: torch.Tensor, coords: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """grid [B, r, r, r, C], continuous coords [B, N, 3] in [0, r-1] ->
    [B, N, C]."""
    r = resolution
    B, C = grid.shape[0], grid.shape[-1]
    N = coords.shape[1]
    flat = grid.reshape(B, r ** 3, C)
    coords = coords.detach().float()
    lo_f = torch.floor(coords)
    frac = coords - lo_f
    lo = lo_f.long()
    step = frac > 0
    hi = lo + step.long()
    w_lo = 1.0 - frac
    w_hi = torch.where(step, frac, torch.zeros_like(frac))
    out = None
    for cx in (0, 1):
        ix, wx = (hi[..., 0], w_hi[..., 0]) if cx else (lo[..., 0], w_lo[..., 0])
        for cy in (0, 1):
            iy, wy = (hi[..., 1], w_hi[..., 1]) if cy else (lo[..., 1], w_lo[..., 1])
            for cz in (0, 1):
                iz, wz = (hi[..., 2], w_hi[..., 2]) if cz else (lo[..., 2], w_lo[..., 2])
                idx = (ix * r + iy) * r + iz
                rows = torch.gather(flat, 1, idx[..., None].expand(B, N, C))
                term = rows * ((wx * wy) * wz)[..., None].to(rows.dtype)
                out = term if out is None else out + term
    return out.to(grid.dtype)


def trilinear_devoxelize_with_mean(grid: torch.Tensor, coords: torch.Tensor,
                                   resolution: int):
    """Devoxelize and also return the per-channel grid mean [B, C] f32
    (the squeeze-excite pooling)."""
    out = trilinear_devoxelize(grid, coords, resolution)
    return out, grid.float().mean(dim=(1, 2, 3))
