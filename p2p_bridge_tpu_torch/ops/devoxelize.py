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

The kernel's grid mean adds in a fixed order in double (see
``grid_mean_fixed_order``, its bit-exact float64 twin on the CPU); the
plain version's is ``grid_mean_plain``, an f32 mean. Without a gradient to
record, the wrappers call the kernel (or the plain version) directly, not
through the autograd Function.
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


# the kernel's mean layout (csrc/devoxelize.cu kThreads, kMaxMeanBlocks,
# kMeanBlockBytes, kRun)
MEAN_THREADS = 256
MAX_MEAN_BLOCKS = 32
MEAN_BLOCK_BYTES = 131072
BF16_RUN = 4
MAX_CHANNELS = 2048


def mean_vector(dtype: torch.dtype, C: int) -> int:
    """Elements in one of the kernel's loads: 16 bytes where C is a multiple
    of them, else 1."""
    vec = 8 if dtype == torch.bfloat16 else 4
    return vec if C % vec == 0 else 1


def mean_blocks(cloud_bytes: int) -> int:
    """The kernel's mean blocks a cloud: its grid's bytes over 128 KB, as a
    power of two from 1 to 32."""
    s = 1
    while s < MAX_MEAN_BLOCKS and 2 * s * MEAN_BLOCK_BYTES <= cloud_bytes:
        s *= 2
    return s


def grid_mean_fixed_order(grid: torch.Tensor) -> torch.Tensor:
    """The kernel's mean [B, C] f32, bit for bit, on the CPU.

    Its order: S = mean_blocks(r^3 * C * element size) blocks a cloud; with
    VEC = mean_vector(dtype, C) elements a load, G = C / VEC channel groups,
    GT = min(G, 256) of them side by side in a block, VLc = 256 // GT voxel
    lanes a block and VL = S * VLc a cloud, voxel lane l takes voxels l,
    l + VL, l + 2 VL, ... in ascending order; f32 values are added one at a
    time into a float64 sum from 0.0, bf16 values in runs of 4 consecutive
    ones of the lane (the last run padded with zeros), each run summed in
    f32 from its first value, in order, and then added to the float64 sum.
    Block k's sum is the sum, from 0.0, of lanes k * VLc .. k * VLc + VLc - 1
    in ascending order; the total is the sum, from 0.0, of the S blocks'
    sums in block order; the mean is total / r^3 in float64, rounded to
    f32."""
    B, C = grid.shape[0], grid.shape[-1]
    x = grid.detach().reshape(B, -1, C)
    V = x.shape[1]
    S = mean_blocks(V * C * grid.element_size())
    GT = min(C // mean_vector(grid.dtype, C), MEAN_THREADS)
    VLc = MEAN_THREADS // GT
    VL = S * VLc
    run = BF16_RUN if grid.dtype == torch.bfloat16 else 1
    lanes = torch.zeros((B, VL, C), dtype=torch.float64, device=x.device)
    for v0 in range(0, V, run * VL):
        acc = None  # one run of each lane: voxels v0 + u * VL + lane, u < run
        for u in range(run):
            part = torch.zeros((B, VL, C), dtype=torch.float32, device=x.device)
            step = x[:, v0 + u * VL:v0 + (u + 1) * VL].float()
            part[:, :step.shape[1]] = step
            acc = part if acc is None else acc + part
        lanes += acc.double()
    blocks = torch.zeros((B, S, C), dtype=torch.float64, device=x.device)
    lanes = lanes.view(B, S, VLc, C)
    for lane in range(VLc):
        blocks += lanes[:, :, lane]
    total = torch.zeros((B, C), dtype=torch.float64, device=x.device)
    for k in range(S):
        total += blocks[:, k]
    return (total / V).float()


def check_devoxelize_shape(B: int, N: int, r: int, C: int) -> None:
    """Raise unless the kernel takes this shape: B, N >= 1, 1 <= C <= 2048
    (the mean's partials fit a block's 48 KB of shared memory) and r^3 * C
    below 2^31 (32-bit row offsets). Every call of the three configs
    qualifies (C <= 512, r <= 32)."""
    if not (B >= 1 and N >= 1 and 1 <= C <= MAX_CHANNELS and r >= 1 and r ** 3 * C < 2 ** 31):
        raise ValueError(f"trilinear_devoxelize kernel takes B, N >= 1, 1 <= C <= "
                         f"{MAX_CHANNELS} and r^3 * C < 2^31; got B={B}, N={N}, r={r}, C={C}")


_tickets: dict = {}  # card index -> the mean's ticket counters, 0 between calls


def _mean_tickets(grid: torch.Tensor, B: int) -> torch.Tensor:
    """B zeroed int32 ticket counters on the grid's card, allocated once (and
    again for a larger B); each call leaves them 0."""
    t = _tickets.get(grid.device.index)
    if t is None or t.numel() < B:
        t = _tickets[grid.device.index] = torch.zeros(max(B, 256), dtype=torch.int32,
                                                      device=grid.device)
    return t


def _devoxelize_cuda(grid, coords, resolution, with_mean):
    B, r, C = grid.shape[0], resolution, grid.shape[-1]
    N = coords.shape[1]
    device = kernels.check(("grid", grid, kernels.DATA, (B, r, r, r, C)),
                           ("coords", coords, torch.float32, (B, N, 3)))
    check_devoxelize_shape(B, N, r, C)
    if grid.data_ptr() % 16:  # read as 16-byte vectors
        grid = grid.clone()
    n_out = B * N * C
    mean = scratch = tickets = None
    if with_mean:
        # one allocation: out, the f32 mean and the mean blocks' double sums,
        # each from a 16-byte boundary
        es = grid.element_size()
        at_mean = -(-n_out * es // 16) * 16
        at_scratch = at_mean + -(-B * C * 4 // 16) * 16
        S = mean_blocks(r ** 3 * C * es)
        buf = grid.new_empty((at_scratch + B * S * C * 8) // es)
        out = buf[:n_out].view(B, N, C)
        mean = buf[at_mean // es:(at_mean + B * C * 4) // es].view(torch.float32).view(B, C)
        scratch = buf.data_ptr() + at_scratch
        tickets = _mean_tickets(grid, B).data_ptr()
    else:
        out = grid.new_empty((B, N, C))
    kernels.launch(
        "trilinear_devoxelize", "p2pb_trilinear_devoxelize", device, grid.data_ptr(),
        coords.data_ptr(), B, N, r, C, int(grid.dtype == torch.bfloat16), out.data_ptr(),
        None if mean is None else mean.data_ptr(), scratch, tickets)
    return out, mean


def _devoxelize_backward_cuda(grad, coords, resolution):
    """The corner scatter on the card: kernel scatter_rows -> [B, r^3, C] of
    grad's dtype."""
    return scatter_rows_cuda(DEVOX, grad.contiguous(), resolution ** 3, coords=coords,
                             resolution=resolution)


def _forward(grid, coords, resolution, with_mean):
    """(out, mean or None): kernel K3 on a CUDA tensor, else the plain version."""
    if kernels.on_card(grid):
        return _devoxelize_cuda(grid, coords, resolution, with_mean)
    out = trilinear_devoxelize_plain(grid, coords, resolution)
    return out, grid_mean_plain(grid) if with_mean else None


class _Devoxelize(torch.autograd.Function):
    """K3 forward (with or without the mean); the backward scatters."""

    @staticmethod
    def forward(ctx, grid, coords, resolution, with_mean):
        ctx.save_for_backward(coords)
        ctx.resolution, ctx.with_mean = resolution, with_mean
        out, mean = _forward(grid, coords, resolution, with_mean)
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


def _devoxelize(grid, coords, resolution, with_mean):
    grid = grid.contiguous()
    coords = coords.detach().float().contiguous()
    if torch.is_grad_enabled() and grid.requires_grad:
        return _Devoxelize.apply(grid, coords, resolution, with_mean)
    out, mean = _forward(grid, coords, resolution, with_mean)  # no graph to record
    return (out, mean) if with_mean else out


def trilinear_devoxelize(grid: torch.Tensor, coords: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """grid [B, r, r, r, C] f32 or bf16, continuous coords [B, N, 3] f32 in
    [0, r-1] -> [B, N, C] of the grid's dtype."""
    return _devoxelize(grid, coords, resolution, False)


def trilinear_devoxelize_with_mean(grid: torch.Tensor, coords: torch.Tensor,
                                   resolution: int):
    """Devoxelize and also return the per-channel grid mean [B, C] f32
    (the squeeze-excite pooling), in one kernel launch on the card (on the
    CPU the plain f32 mean; ``grid_mean_fixed_order`` is the kernel's)."""
    return _devoxelize(grid, coords, resolution, True)
