"""Point-cloud operations of PVCNN2 and of patch-based denoising in plain
float32 PyTorch, channels-last (points [B, N, C], grids [B, r, r, r, C]).

Each follows the published CUDA operations of PVCNN / PVD, which the
program's kernels implement: first index 0 and ties to the lowest index
in furthest point sampling; the first K points in index order inside the
ball, padded with the first hit; average voxelization over the coordinates
normalised into the unit cube; trilinear devoxelization with the high
corner taken only where the fraction is positive; inverse-distance
interpolation over the three nearest centres. Gradients are autograd's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, 3], [B, N, 3] -> [B, M, N] as (dx*dx + dy*dy) + dz*dz."""
    d = None
    for c in range(3):
        diff = a[..., :, None, c] - b[..., None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def sqdist_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, N] as |a|^2 - 2 a.b + |b|^2, clamped at 0 (the kNN's form)."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    return (a2 - 2.0 * torch.matmul(a, b.transpose(-1, -2)) + b2.transpose(-1, -2)).clamp_min(0)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [B, N, ...] at idx [B, ...]."""
    b = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[b, idx.long()]


def fps(coords: torch.Tensor, m: int) -> torch.Tensor:
    """Furthest point sampling [B, N, 3] -> [B, m] int64: start at 0, keep
    each point's squared distance to the picked set, take the first
    maximum."""
    coords = coords.float()
    B, N, _ = coords.shape
    x, y, z = coords.unbind(-1)
    dists = torch.full((B, N), torch.finfo(torch.float32).max, device=coords.device)
    out = torch.zeros((B, m), dtype=torch.long, device=coords.device)
    rows = torch.arange(B, device=coords.device)
    last = torch.zeros(B, dtype=torch.long, device=coords.device)
    for j in range(1, m):
        p = coords[rows, last]
        dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
        dists = torch.minimum(dists, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(dists, dim=-1)
        out[:, j] = last
    return out


def knn(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, M, k] of the k nearest points, equal distances in index
    order."""
    return torch.sort(sqdist_mm(query.float(), points.float()), dim=-1, stable=True)[1][..., :k]


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float, k: int):
    """[B, M, k] int64: the first k points in index order with squared
    distance below radius^2 (rounded to f32); further slots repeat the
    first hit; a centre with no hit takes 0."""
    N = points.shape[1]
    mask = sqdist(centers.float(), points.float()) < float(np.float32(radius * radius))
    order = torch.arange(N, device=points.device)
    key = torch.where(mask, N - order, torch.zeros_like(order))
    vals = torch.topk(key, min(k, N), dim=-1, sorted=True).values
    if k > N:
        vals = F.pad(vals, (0, k - N))
    first = torch.argmax(mask.to(torch.int8), dim=-1)
    return torch.where(vals > 0, N - vals, first[..., None])


def group_relative(centers, points, features, radius: float, k: int) -> torch.Tensor:
    """[points[idx] - centre | features[idx]] [B, M, k, 3 + C]."""
    idx = ball_query(centers, points, radius, k)
    rel = take(points, idx) - centers[:, :, None, :]
    return torch.cat([rel, take(features, idx)], dim=-1)


def voxel_coords(coords: torch.Tensor, r: int):
    """(integer voxel [B, N, 3], continuous [B, N, 3]) of the cloud centred,
    scaled by twice its largest norm into the unit cube, times r, clamped to
    [0, r - 1]; rounding half to even."""
    coords = coords.detach().float()
    centred = coords - coords.mean(dim=1, keepdim=True)
    norm = torch.linalg.norm(centred, dim=-1, keepdim=True).amax(dim=1, keepdim=True)
    scaled = torch.clamp((centred / torch.clamp_min(norm * 2.0, 1e-12) + 0.5) * r, 0.0, r - 1.0)
    return torch.round(scaled).long(), scaled


def voxelize(features: torch.Tensor, vox: torch.Tensor, r: int) -> torch.Tensor:
    """Per-voxel mean [B, r, r, r, C] of the features (empty voxels 0)."""
    B, N, C = features.shape
    idx = (vox[..., 0] * r + vox[..., 1]) * r + vox[..., 2]
    acc = features.new_zeros((B, r ** 3, C)).scatter_add(1, idx[..., None].expand(B, N, C),
                                                          features)
    cnt = features.new_zeros((B, r ** 3)).scatter_add(1, idx, torch.ones_like(features[..., 0]))
    return (acc / cnt.clamp_min(1.0)[..., None].detach()).view(B, r, r, r, C)


def devoxelize(grid: torch.Tensor, coords: torch.Tensor, r: int) -> torch.Tensor:
    """Trilinear interpolation [B, N, C] of the grid at continuous coords."""
    B, C = grid.shape[0], grid.shape[-1]
    N = coords.shape[1]
    lo_f = torch.floor(coords)
    frac = coords - lo_f
    lo = lo_f.long()
    step = frac > 0
    hi = lo + step.long()
    w_lo, w_hi = 1.0 - frac, torch.where(step, frac, torch.zeros_like(frac))
    flat = grid.reshape(B, r ** 3, C)
    out = 0.0
    for cx in (0, 1):
        ix, wx = (hi[..., 0], w_hi[..., 0]) if cx else (lo[..., 0], w_lo[..., 0])
        for cy in (0, 1):
            iy, wy = (hi[..., 1], w_hi[..., 1]) if cy else (lo[..., 1], w_lo[..., 1])
            for cz in (0, 1):
                iz, wz = (hi[..., 2], w_hi[..., 2]) if cz else (lo[..., 2], w_lo[..., 2])
                idx = (ix * r + iy) * r + iz
                rows = torch.gather(flat, 1, idx[..., None].expand(B, N, C))
                out = out + rows * ((wx * wy) * wz)[..., None]
    return out


def three_nn_interpolate(points, centers, features) -> torch.Tensor:
    """Inverse-distance weights over the three nearest centres (squared
    distances clamped to [1e-10, 1e10], ties to the lowest index)."""
    work = sqdist(points.float(), centers.float())
    M = centers.shape[1]
    ds, idxs = [], []
    for _ in range(min(3, M)):
        i = torch.argmin(work, dim=-1, keepdim=True)
        ds.append(torch.gather(work, -1, i))
        idxs.append(i)
        work = work.scatter(-1, i, float("inf"))
    d, idx = torch.cat(ds, -1), torch.cat(idxs, -1)
    if M < 3:
        d, idx = F.pad(d, (0, 3 - M), value=1e10), F.pad(idx, (0, 3 - M))
    d = d.clamp(1e-10, 1e10)
    d0, d1, d2 = d.unbind(-1)
    w = torch.stack([d1 * d2, d0 * d2, d0 * d1], -1) / (d0 * d1 + d0 * d2 + d1 * d2)[..., None]
    return (take(features, idx) * w[..., None]).sum(dim=2)


def group_norm(x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Normalised per (cloud, group) over every other axis, variance
    E[x^2] - E[x]^2 clamped at 0; no affine."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.reshape(B, -1, groups, C // groups)
    m = xg.mean(dim=(1, 3), keepdim=True)
    v = ((xg * xg).mean(dim=(1, 3), keepdim=True) - m * m).clamp_min(0.0)
    return ((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
