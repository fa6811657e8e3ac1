"""Average voxelization (port of p2p_bridge_tpu/ops/voxelize.py, forward).

Flat index x*r^2 + y*r + z, per-voxel f32 feature sum and point count,
output sum / max(count, 1) in the features' dtype (f32 or bf16). On a CUDA
tensor :func:`avg_voxelize` launches kernel K2 (``csrc/voxelize.cu``); on
a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels


def flat_voxel_index(vox_coords: torch.Tensor, resolution: int) -> torch.Tensor:
    r = resolution
    return vox_coords[..., 0] * (r * r) + vox_coords[..., 1] * r + vox_coords[..., 2]


def normalize_coords_to_voxels(coords: torch.Tensor, resolution: int):
    """Centre, scale by twice the largest point norm into the unit cube,
    clamp to [0, r-1] and round (the JAX package's defaults, normalize=True
    and eps=0, which every PVConv uses).

    Returns (vox int32 [B, N, 3], continuous coords f32 [B, N, 3]); the
    continuous coords feed devoxelization."""
    coords = coords.detach().float()
    centered = coords - coords.mean(dim=1, keepdim=True)
    max_norm = torch.linalg.norm(centered, dim=-1, keepdim=True).amax(dim=1, keepdim=True)
    # an all-identical cloud would divide by 0: clamp, as the JAX package does
    centered = centered / torch.clamp_min(max_norm * 2.0, 1e-12) + 0.5
    scaled = torch.clamp(centered * resolution, 0.0, resolution - 1.0)
    vox = torch.round(scaled).int()  # half to even, like jnp.round
    return vox, scaled


def avg_voxelize_plain(features: torch.Tensor, vox_coords: torch.Tensor,
                       resolution: int) -> torch.Tensor:
    B, N, C = features.shape
    r3 = resolution ** 3
    idx = flat_voxel_index(vox_coords, resolution).long()
    acc = torch.zeros((B, r3, C), dtype=torch.float32, device=features.device)
    acc.scatter_add_(1, idx[..., None].expand(B, N, C), features.float())
    cnt = torch.zeros((B, r3), dtype=torch.float32, device=features.device)
    cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    grid = acc / cnt.clamp_min(1.0)[..., None]
    return grid.reshape(B, resolution, resolution, resolution, C).to(features.dtype)


def _avg_voxelize_cuda(features, vox_coords, resolution):
    B, N, C = features.shape
    r = resolution
    dev, dt = features.device, kernels.data_dtype(features)
    kernels.require(features, "features", dt, (B, N, C), dev)
    kernels.require(vox_coords, "vox_coords", torch.int32, (B, N, 3), dev)
    if max(B * N, B * r ** 3) * C >= 2 ** 31:
        raise ValueError(f"avg_voxelize: B={B}, N={N}, r={r}, C={C} overflow 32-bit indices")
    acc = torch.zeros((B, r ** 3, C), dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, r ** 3), dtype=torch.float32, device=dev)
    out = acc if dt == torch.float32 else torch.empty((B, r ** 3, C), dtype=dt, device=dev)
    kernels.launch(
        "avg_voxelize", "p2pb_avg_voxelize", dev, features.data_ptr(),
        vox_coords.data_ptr(), B, N, C, r, int(dt == torch.bfloat16),
        acc.data_ptr(), cnt.data_ptr(), out.data_ptr())
    return out.view(B, r, r, r, C)


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """features [B, N, C], int32 voxel coords [B, N, 3] in [0, r-1] ->
    grid [B, r, r, r, C] of per-voxel means (empty voxels 0)."""
    if kernels.on_card(features):
        return _avg_voxelize_cuda(features, vox_coords, resolution)
    return avg_voxelize_plain(features, vox_coords, resolution)
