"""Trilinear devoxelization (port of p2p_bridge_tpu/ops/devoxelize.py).

CUDA corner rule: per axis the low corner is floor(c) with weight 1 - frac,
and the high corner steps to floor(c) + 1 only when frac > 0 (weight frac).
Corner weights are f32, the sum is f32, and the result takes the grid's
dtype (f32 or bf16). On a CUDA tensor both functions launch kernel K3
(``csrc/devoxelize.cu``); on a CPU tensor they run the plain version.

The backward is the JAX package's (devoxelize.py ``_devox_bwd`` and
``_devox_mean_bwd``): each point's gradient row, weighted by (wx * wy) *
(wz * g), is added into its corner voxels in f32 and the grid gradient is
rounded once to the grid's dtype; the mean's gradient adds g_mean / r^3 to
every voxel. The coordinates get no gradient. On a CUDA tensor the scatter
is kernel ``scatter_rows`` (``ops/scatter.py``), bit-equal to the plain
version (``index_add_``, corner by corner) run on the CPU; the JAX package
has no Pallas kernel here.
"""

from __future__ import annotations

import torch

from .. import kernels
from .scatter import DEVOX, scatter_rows_cuda


def _corners(coords: torch.Tensor, r: int):
    """The 8 corners of each point, x outer and z inner: [(flat voxel index
    [B, N], wx, wy, wz)], each weight [B, N] f32."""
    coords = coords.detach().float()
    lo_f = torch.floor(coords)
    frac = coords - lo_f
    lo = lo_f.long()
    step = frac > 0
    hi = lo + step.long()
    w_lo = 1.0 - frac
    w_hi = torch.where(step, frac, torch.zeros_like(frac))
    out = []
    for cx in (0, 1):
        ix, wx = (hi[..., 0], w_hi[..., 0]) if cx else (lo[..., 0], w_lo[..., 0])
        for cy in (0, 1):
            iy, wy = (hi[..., 1], w_hi[..., 1]) if cy else (lo[..., 1], w_lo[..., 1])
            for cz in (0, 1):
                iz, wz = (hi[..., 2], w_hi[..., 2]) if cz else (lo[..., 2], w_lo[..., 2])
                out.append(((ix * r + iy) * r + iz, wx, wy, wz))
    return out


def trilinear_devoxelize_plain(grid: torch.Tensor, coords: torch.Tensor,
                               resolution: int) -> torch.Tensor:
    """Corner by corner, x outer and z inner, each term (wx * wy) * wz *
    row added to an f32 sum: the kernel's order and rounding."""
    r = resolution
    B, C = grid.shape[0], grid.shape[-1]
    N = coords.shape[1]
    flat = grid.reshape(B, r ** 3, C)
    out = None
    for idx, wx, wy, wz in _corners(coords, r):
        rows = torch.gather(flat, 1, idx[..., None].expand(B, N, C)).float()
        term = rows * ((wx * wy) * wz)[..., None]
        out = term if out is None else out + term
    return out.to(grid.dtype)


def trilinear_devoxelize_backward(grad: torch.Tensor, coords: torch.Tensor,
                                  resolution: int) -> torch.Tensor:
    """The plain scatter: grad [B, N, C] -> grid gradient [B, r^3, C] f32;
    each corner gets (wx * wy) * (wz * grad) of each point, added with
    index_add_ corner by corner."""
    r = resolution
    B, N, C = grad.shape
    g = grad.float()
    base = (torch.arange(B, device=grad.device) * r ** 3)[:, None]
    out = torch.zeros((B * r ** 3, C), dtype=torch.float32, device=grad.device)
    for idx, wx, wy, wz in _corners(coords, r):
        term = (wx * wy)[..., None] * (wz[..., None] * g)
        out.index_add_(0, (idx + base).reshape(-1), term.reshape(B * N, C))
    return out.view(B, r ** 3, C)


def grid_mean_plain(grid: torch.Tensor) -> torch.Tensor:
    """Per-channel mean [B, C] f32 over the r^3 voxels."""
    return grid.float().mean(dim=(1, 2, 3))


def _devoxelize_cuda(grid, coords, resolution, with_mean):
    B, r, C = grid.shape[0], resolution, grid.shape[-1]
    N = coords.shape[1]
    device = kernels.check(("grid", grid, kernels.DATA, (B, r, r, r, C)),
                           ("coords", coords, torch.float32, (B, N, 3)))
    dev, dt = grid.device, grid.dtype
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    mean = scratch = None
    if with_mean:
        mean = torch.empty((B, C), dtype=torch.float32, device=dev)
        scratch = torch.empty(kernels.entry_points()["p2pb_devoxelize_scratch_bytes"](B, r, C),
                              dtype=torch.uint8, device=dev)
    kernels.launch(
        "trilinear_devoxelize", "p2pb_trilinear_devoxelize", device, grid.data_ptr(),
        coords.data_ptr(), B, N, r, C, int(dt == torch.bfloat16), out.data_ptr(),
        None if mean is None else mean.data_ptr(),
        None if scratch is None else scratch.data_ptr())
    return out, mean


def _devoxelize_backward_cuda(grad, coords, resolution):
    """The corner scatter on the card: kernel scatter_rows -> [B, r^3, C] of
    grad's dtype."""
    return scatter_rows_cuda(DEVOX, grad.contiguous(), resolution ** 3, coords=coords,
                             resolution=resolution)


class _Devoxelize(torch.autograd.Function):
    """K3 forward (with or without the mean); the backward scatters."""

    @staticmethod
    def forward(ctx, grid, coords, resolution, with_mean):
        ctx.save_for_backward(coords)
        ctx.resolution, ctx.with_mean = resolution, with_mean
        if kernels.on_card(grid):
            out, mean = _devoxelize_cuda(grid, coords, resolution, with_mean)
        else:
            out = trilinear_devoxelize_plain(grid, coords, resolution)
            mean = grid_mean_plain(grid) if with_mean else None
        return (out, mean) if with_mean else out

    @staticmethod
    def backward(ctx, grad, grad_mean=None):
        (coords,) = ctx.saved_tensors
        r = ctx.resolution
        B, C = grad.shape[0], grad.shape[-1]
        if kernels.on_card(grad):
            dgrid = _devoxelize_backward_cuda(grad, coords, r)
        else:
            dgrid = trilinear_devoxelize_backward(grad, coords, r).to(grad.dtype)
        if ctx.with_mean and grad_mean is not None:
            # rounded to the grid's dtype first, then added: _devox_mean_bwd
            dgrid = dgrid + (grad_mean.float() / float(r ** 3)).to(dgrid.dtype)[:, None, :]
        return dgrid.view(B, r, r, r, C), None, None, None


def trilinear_devoxelize(grid: torch.Tensor, coords: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """grid [B, r, r, r, C] f32 or bf16, continuous coords [B, N, 3] f32 in
    [0, r-1] -> [B, N, C] of the grid's dtype."""
    return _Devoxelize.apply(grid.contiguous(), coords.detach().float().contiguous(),
                             resolution, False)


def trilinear_devoxelize_with_mean(grid: torch.Tensor, coords: torch.Tensor,
                                   resolution: int):
    """Devoxelize and also return the per-channel grid mean [B, C] f32
    (the squeeze-excite pooling), in one kernel launch on the card."""
    return _Devoxelize.apply(grid.contiguous(), coords.detach().float().contiguous(),
                             resolution, True)
