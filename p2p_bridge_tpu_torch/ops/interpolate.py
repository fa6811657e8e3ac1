"""3-nearest-neighbour inverse-distance interpolation (port of
p2p_bridge_tpu/ops/interpolate.py).

The 3 nearest centres by squared distance from per-coordinate squares,
ties to the lowest index (the Pallas kernel's rule); squared distances
clamped to [1e-10, 1e10]; w_i = d_j d_k / (d0 d1 + d0 d2 + d1 d2). With
fewer than 3 centres the missing slots get index 0 and distance 1e10. The
weighted sum is f32 and takes the features' dtype (f32 or bf16); the
weights carry no gradient. On a CUDA tensor
:func:`nearest_neighbor_interpolate` launches kernel K6
(``csrc/interpolate.cu``); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .common import batched_take, pairwise_sqdist_exact


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """points [B, N, 3], centers [B, M, 3] -> (weights [B, N, 3] f32,
    indices [B, N, 3] int32), in plain PyTorch: three first-minimum
    passes (torch.argmin returns the first of equal values)."""
    M = centers.shape[1]
    work = pairwise_sqdist_exact(points, centers)  # [B, N, M]
    ds, idxs = [], []
    for _ in range(min(3, M)):
        i = torch.argmin(work, dim=-1, keepdim=True)
        ds.append(torch.gather(work, -1, i))
        idxs.append(i)
        work = work.scatter(-1, i, float("inf"))
    d, idx = torch.cat(ds, dim=-1), torch.cat(idxs, dim=-1)
    if M < 3:
        d = F.pad(d, (0, 3 - M), value=1e10)
        idx = F.pad(idx, (0, 3 - M))
    d = d.clamp(1e-10, 1e10)
    d0, d1, d2 = d.unbind(-1)
    denom = d0 * d1 + d0 * d2 + d1 * d2
    w = torch.stack([d1 * d2, d0 * d2, d0 * d1], dim=-1) / denom[..., None]
    return w, idx.int()


def three_nn_interpolate_plain(points, centers, features):
    """-> (out [B, N, C] of features' dtype, weights, indices)."""
    w, idx = three_nn(points, centers)
    neighbors = batched_take(features, idx).float()  # [B, N, 3, C]
    out = (neighbors * w.detach()[..., None]).sum(dim=2)
    return out.to(features.dtype), w, idx


def _three_nn_interpolate_cuda(points, centers, features, with_weights):
    B, N, _ = points.shape
    M, C = centers.shape[1], features.shape[-1]
    dev, dt = points.device, kernels.data_dtype(features)
    kernels.require(points, "points", torch.float32, (B, N, 3), dev)
    kernels.require(centers, "centers", torch.float32, (B, M, 3), dev)
    kernels.require(features, "features", dt, (B, M, C), dev)
    if M < 1:
        raise ValueError("three_nn_interpolate needs at least one centre")
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    w = idx = None
    if with_weights:
        w = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
        idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    kernels.launch(
        "three_nn_interpolate", "p2pb_three_nn_interpolate", dev, points.data_ptr(),
        centers.data_ptr(), features.data_ptr(), B, N, M, C, int(dt == torch.bfloat16),
        out.data_ptr(), w.data_ptr() if with_weights else None,
        idx.data_ptr() if with_weights else None)
    return out, w, idx


def three_nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                         features: torch.Tensor, with_weights: bool = True):
    """Fine points [B, N, 3] f32, coarse centres [B, M, 3] f32 and features
    [B, M, C] f32 or bf16 -> (out [B, N, C] of the features' dtype,
    weights [B, N, 3] f32, indices [B, N, 3] int32); weights and indices
    are None when ``with_weights`` is false, and the kernel skips them."""
    if kernels.on_card(points):
        return _three_nn_interpolate_cuda(points.float().contiguous(),
                                          centers.float().contiguous(), features.contiguous(),
                                          with_weights)
    out, w, idx = three_nn_interpolate_plain(points, centers, features)
    return (out, w, idx) if with_weights else (out, None, None)


def nearest_neighbor_interpolate(points: torch.Tensor, centers: torch.Tensor,
                                 features: torch.Tensor) -> torch.Tensor:
    """Fine points [B, N, 3], coarse centres [B, M, 3] and features
    [B, M, C] -> [B, N, C]."""
    return three_nn_interpolate(points, centers, features, with_weights=False)[0]
