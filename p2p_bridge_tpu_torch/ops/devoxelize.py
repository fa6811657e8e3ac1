"""Trilinear devoxelization (port of p2p_bridge_tpu/ops/devoxelize.py).

CUDA corner rule: per axis the low corner is floor(c) with weight 1 - frac,
and the high corner steps to floor(c) + 1 only when frac > 0 (weight frac).
Corner weights are f32, the sum is f32, and the result takes the grid's
dtype (f32 or bf16). On a CUDA tensor both functions launch kernel K3
(``csrc/devoxelize.cu``); on a CPU tensor they run the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels


def trilinear_devoxelize_plain(grid: torch.Tensor, coords: torch.Tensor,
                               resolution: int) -> torch.Tensor:
    """Corner by corner, x outer and z inner, each term (wx * wy) * wz *
    row added to an f32 sum: the kernel's order and rounding."""
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
                rows = torch.gather(flat, 1, idx[..., None].expand(B, N, C)).float()
                term = rows * ((wx * wy) * wz)[..., None]
                out = term if out is None else out + term
    return out.to(grid.dtype)


def grid_mean_plain(grid: torch.Tensor) -> torch.Tensor:
    """Per-channel mean [B, C] f32 over the r^3 voxels."""
    return grid.float().mean(dim=(1, 2, 3))


def _devoxelize_cuda(grid, coords, resolution, with_mean):
    B, r, C = grid.shape[0], resolution, grid.shape[-1]
    N = coords.shape[1]
    dev, dt = grid.device, kernels.data_dtype(grid)
    kernels.require(grid, "grid", dt, (B, r, r, r, C), dev)
    kernels.require(coords, "coords", torch.float32, (B, N, 3), dev)
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    mean = scratch = None
    if with_mean:
        lib = kernels.library()
        mean = torch.empty((B, C), dtype=torch.float32, device=dev)
        scratch = torch.empty(lib.p2pb_devoxelize_scratch_bytes(B, r, C),
                              dtype=torch.uint8, device=dev)
    kernels.launch(
        "trilinear_devoxelize", "p2pb_trilinear_devoxelize", dev, grid.data_ptr(),
        coords.data_ptr(), B, N, r, C, int(dt == torch.bfloat16), out.data_ptr(),
        None if mean is None else mean.data_ptr(),
        None if scratch is None else scratch.data_ptr())
    return out, mean


def trilinear_devoxelize(grid: torch.Tensor, coords: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """grid [B, r, r, r, C] f32 or bf16, continuous coords [B, N, 3] f32 in
    [0, r-1] -> [B, N, C] of the grid's dtype."""
    if kernels.on_card(grid):
        return _devoxelize_cuda(grid.contiguous(), coords.detach().float().contiguous(),
                                resolution, False)[0]
    return trilinear_devoxelize_plain(grid, coords, resolution)


def trilinear_devoxelize_with_mean(grid: torch.Tensor, coords: torch.Tensor,
                                   resolution: int):
    """Devoxelize and also return the per-channel grid mean [B, C] f32
    (the squeeze-excite pooling), in one kernel launch on the card."""
    if kernels.on_card(grid):
        return _devoxelize_cuda(grid.contiguous(), coords.detach().float().contiguous(),
                                resolution, True)
    return trilinear_devoxelize_plain(grid, coords, resolution), grid_mean_plain(grid)
