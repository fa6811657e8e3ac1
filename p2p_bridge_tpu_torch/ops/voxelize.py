"""Average voxelization (port of p2p_bridge_tpu/ops/voxelize.py).

Flat index x*r^2 + y*r + z, per-voxel f32 feature sum and point count,
output sum / max(count, 1) in the features' dtype (f32 or bf16). The
backward (the CUDA rule the JAX package follows, ``_avp_bwd``) gives each
point f32(grad[idx]) / max(count[idx], 1), rounded once to the features'
dtype, with the forward's counts. On a CUDA tensor :func:`avg_voxelize`
launches kernel K2 forward and kernel K2b backward (``csrc/voxelize.cu``);
on a CPU tensor both run their plain versions.

Each voxel's sum runs over its points in ascending point index, in f32,
from 0: the order of ``scatter_add_`` on the CPU, which K2 keeps (it sorts
the points by voxel), so the card's grid and counts are bit-equal to the
plain version's on the CPU and the same from run to run.
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


MAX_POINTS = 4096  # K2's sort keys hold the point index in 12 bits
MAX_RESOLUTION = 32  # a cloud's keys and r^3 counts fit one block's shared memory


def check_voxelize_shape(B: int, N: int, r: int, C: int) -> None:
    """Raise unless kernel K2 takes this shape: 1 <= N <= 4096 points a
    cloud, 1 <= r <= 32, 1 <= B < 65536 clouds (the grid's y dimension) and
    a cloud's grid and features below 2^31 elements (32-bit offsets). Every
    voxelize call of the three configs qualifies (N <= 4096, r <= 32)."""
    if not (1 <= N <= MAX_POINTS and 1 <= r <= MAX_RESOLUTION and 1 <= B < 2 ** 16
            and C >= 1 and max(N, r ** 3) * C < 2 ** 31):
        raise ValueError(f"avg_voxelize kernel takes 1 <= N <= {MAX_POINTS}, "
                         f"1 <= r <= {MAX_RESOLUTION}, 1 <= B < 65536 and r^3 * C, "
                         f"N * C below 2^31; got B={B}, N={N}, r={r}, C={C}")


def _avg_voxelize_cuda(features, vox_coords, resolution):
    """(grid [B, r^3, C], counts [B, r^3] f32) from kernel K2."""
    B, N, C = features.shape
    r = resolution
    check_voxelize_shape(B, N, r, C)
    device = kernels.check(("features", features, kernels.DATA, (B, N, C)),
                           ("vox_coords", vox_coords, torch.int32, (B, N, 3)))
    if features.data_ptr() % 16:  # read as 16-byte vectors
        features = features.clone()
    out = features.new_empty((B, r ** 3, C))
    cnt = features.new_empty((B, r ** 3), dtype=torch.float32)
    # the kernel's sorted point order [B, N] and segment starts [B, r^3 + 1]
    tables = features.new_empty(B * (N + r ** 3 + 1), dtype=torch.int32)
    kernels.launch(
        "avg_voxelize", "p2pb_avg_voxelize", device, features.data_ptr(),
        vox_coords.data_ptr(), B, N, C, r, int(features.dtype == torch.bfloat16),
        cnt.data_ptr(), out.data_ptr(), tables.data_ptr())
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
    N = idx.shape[-1]
    device = kernels.check(("grad", grad, kernels.DATA, (B, R3, C)),
                           ("idx", idx, torch.int32, (B, N)),
                           ("cnt", cnt, torch.float32, (B, R3)))
    if B >= 2 ** 16 or max(N, R3) * C >= 2 ** 31:
        raise ValueError(f"avg_voxelize_backward: B={B}, N={N}, R3={R3}, C={C} exceed "
                         "the kernel's grid or 32-bit offsets")
    if grad.data_ptr() % 16:  # read as 16-byte vectors
        grad = grad.clone()
    out = grad.new_empty((B, N, C))
    kernels.launch(
        "avg_voxelize_backward", "p2pb_avg_voxelize_backward", device, grad.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), B, N, R3, C, int(grad.dtype == torch.bfloat16),
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
    grid [B, r, r, r, C] of per-voxel means (empty voxels 0). Without a
    gradient to track it skips the autograd node and its saved indices."""
    features = features.contiguous()
    if torch.is_grad_enabled() and features.requires_grad:
        return _AvgVoxelize.apply(features, vox_coords, resolution)
    if kernels.on_card(features):
        grid = _avg_voxelize_cuda(features, vox_coords, resolution)[0]
    else:
        grid = _avg_voxelize_plain(features, vox_coords, resolution)[0]
    B, C, r = features.shape[0], features.shape[-1], resolution
    return grid.view(B, r, r, r, C)
