"""Average voxelization (port of p2p_bridge_tpu/ops/voxelize.py).

Flat index x*r^2 + y*r + z, per-voxel f32 feature sum and point count,
output sum / max(count, 1) in the features' dtype (f32 or bf16). The
backward (the CUDA rule the JAX package follows, ``_avp_bwd``) gives each
point f32(grad[idx]) / max(count[idx], 1), rounded once to the features'
dtype, with the forward's counts. On a CUDA tensor :func:`avg_voxelize`
launches kernel K2 forward and kernel K2b backward (``csrc/voxelize.cu``);
on a CPU tensor both run their plain versions.
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


def _avg_voxelize_plain(features, vox_coords, resolution):
    """(grid [B, r^3, C] of the features' dtype, counts [B, r^3] f32)."""
    B, N, C = features.shape
    r3 = resolution ** 3
    idx = flat_voxel_index(vox_coords, resolution).long()
    acc = torch.zeros((B, r3, C), dtype=torch.float32, device=features.device)
    acc.scatter_add_(1, idx[..., None].expand(B, N, C), features.float())
    cnt = torch.zeros((B, r3), dtype=torch.float32, device=features.device)
    cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    grid = acc / cnt.clamp_min(1.0)[..., None]
    return grid.to(features.dtype), cnt


def avg_voxelize_plain(features: torch.Tensor, vox_coords: torch.Tensor,
                       resolution: int) -> torch.Tensor:
    r = resolution
    grid = _avg_voxelize_plain(features, vox_coords, r)[0]
    return grid.reshape(features.shape[0], r, r, r, features.shape[-1])


def _avg_voxelize_cuda(features, vox_coords, resolution):
    """(grid [B, r^3, C], counts [B, r^3] f32) from kernel K2."""
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
    return out, cnt


def avg_voxelize_backward_plain(grad: torch.Tensor, idx: torch.Tensor,
                                cnt: torch.Tensor) -> torch.Tensor:
    """grad [B, r^3, C], flat indices idx [B, N], counts [B, r^3] f32 ->
    [B, N, C] of grad's dtype: f32(grad[idx]) / max(cnt[idx], 1)."""
    B, N = idx.shape
    C = grad.shape[-1]
    idx = idx.long()
    rows = torch.gather(grad, 1, idx[..., None].expand(B, N, C)).float()
    den = torch.gather(cnt, 1, idx).clamp_min(1.0)
    return (rows / den[..., None]).to(grad.dtype)


def _avg_voxelize_backward_cuda(grad, idx, cnt):
    B, R3, C = grad.shape
    N = idx.shape[1]
    dev, dt = grad.device, kernels.data_dtype(grad)
    kernels.require(grad, "grad", dt, (B, R3, C), dev)
    kernels.require(idx, "idx", torch.int32, (B, N), dev)
    kernels.require(cnt, "cnt", torch.float32, (B, R3), dev)
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    kernels.launch(
        "avg_voxelize_backward", "p2pb_avg_voxelize_backward", dev, grad.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), B, N, R3, C, int(dt == torch.bfloat16),
        out.data_ptr())
    return out


def avg_voxelize_backward(grad: torch.Tensor, idx: torch.Tensor,
                          cnt: torch.Tensor) -> torch.Tensor:
    """The voxelize backward: kernel K2b on a CUDA tensor, the plain
    version on a CPU tensor."""
    if kernels.on_card(grad):
        return _avg_voxelize_backward_cuda(grad.contiguous(), idx, cnt)
    return avg_voxelize_backward_plain(grad, idx, cnt)


class _AvgVoxelize(torch.autograd.Function):
    """K2 forward, K2b backward; the voxel coordinates get no gradient."""

    @staticmethod
    def forward(ctx, features, vox_coords, resolution):
        if kernels.on_card(features):
            grid, cnt = _avg_voxelize_cuda(features, vox_coords, resolution)
        else:
            grid, cnt = _avg_voxelize_plain(features, vox_coords, resolution)
        ctx.save_for_backward(flat_voxel_index(vox_coords, resolution).int(), cnt)
        B, C, r = features.shape[0], features.shape[-1], resolution
        return grid.view(B, r, r, r, C)

    @staticmethod
    def backward(ctx, grad):
        idx, cnt = ctx.saved_tensors
        B, C = grad.shape[0], grad.shape[-1]
        return avg_voxelize_backward(grad.reshape(B, -1, C), idx, cnt), None, None


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """features [B, N, C], int32 voxel coords [B, N, 3] in [0, r-1] ->
    grid [B, r, r, r, C] of per-voxel means (empty voxels 0)."""
    return _AvgVoxelize.apply(features.contiguous(), vox_coords, resolution)
