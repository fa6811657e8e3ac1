"""Fused ball query + group (port of p2p_bridge_tpu/ops/ball_query.py,
grouping.py and fused_group.py).

For each centre: the first K points in index order with squared distance
(per-coordinate squares) < radius^2; slots past the hit count repeat the
first hit; a centre with no hit gets index 0. The rows at those indices
are gathered in their own dtype (f32 or bf16; the distances are f32 from
f32 coordinates). On a CUDA tensor :func:`ball_query_group` launches
kernel K4 (``csrc/ball_query_group.cu``); on a CPU tensor it runs the
plain version.

The backward is the JAX package's (fused_group.py ``_fused_tpu_bwd``, the
CUDA grouping backward): each gathered row's gradient is added into the row
it came from (in f32, rounded once to the rows' dtype); centres and points
get no gradient. On a CUDA tensor it is kernel ``scatter_rows``
(``ops/scatter.py``), bit-equal to the plain version (``index_add_``) run
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .common import batched_take, pairwise_sqdist_exact
from .scatter import GATHER, scatter_rows_cuda


def _radius_sq(radius: float) -> float:
    # radius^2 rounded to f32 once, as the JAX package compares against it
    return float(np.float32(radius * radius))


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int) -> torch.Tensor:
    """Plain PyTorch ball query: [B, M, 3], [B, N, 3] -> idx [B, M, K] int32."""
    N = points.shape[1]
    K = num_neighbors
    mask = pairwise_sqdist_exact(centers, points) < _radius_sq(radius)  # [B, M, N]
    iota = torch.arange(N, device=points.device)
    # hits ranked by ascending index: key N - i (> 0); misses get 0
    key = torch.where(mask, N - iota, torch.zeros_like(iota))
    vals = torch.topk(key, min(K, N), dim=-1, sorted=True).values
    if K > N:
        vals = torch.nn.functional.pad(vals, (0, K - N))
    first_hit = torch.argmax(mask.to(torch.int8), dim=-1)  # 0 when no hit
    idx = torch.where(vals > 0, N - vals, first_hit[..., None])
    return idx.int()


def ball_query_group_plain(centers, points, rows, radius, num_neighbors):
    idx = ball_query(centers, points, radius, num_neighbors)
    return batched_take(rows, idx), idx


def _ball_query_group_cuda(centers, points, rows, radius, num_neighbors):
    B, M, _ = centers.shape
    N, C, K = points.shape[1], rows.shape[-1], num_neighbors
    device = kernels.check(("centers", centers, torch.float32, (B, M, 3)),
                           ("points", points, torch.float32, (B, N, 3)),
                           ("rows", rows, kernels.DATA, (B, N, C)))
    dev, dt = centers.device, rows.dtype
    out = torch.empty((B, M, K, C), dtype=dt, device=dev)
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    kernels.launch(
        "ball_query_group", "p2pb_ball_query_group", device, centers.data_ptr(),
        points.data_ptr(), rows.data_ptr(), B, M, N, C, K,
        _radius_sq(radius), int(dt == torch.bfloat16), out.data_ptr(), idx.data_ptr())
    return out, idx


def ball_query_group_backward(grad: torch.Tensor, idx: torch.Tensor,
                              num_points: int) -> torch.Tensor:
    """The plain scatter: grad [B, M, K, C], idx [B, M, K] -> rows' gradient
    [B, N, C] f32, added with index_add_ in (m, k) order."""
    B, C = grad.shape[0], grad.shape[-1]
    base = (torch.arange(B, device=grad.device) * num_points)[:, None, None]
    out = torch.zeros((B * num_points, C), dtype=torch.float32, device=grad.device)
    out.index_add_(0, (idx.long() + base).reshape(-1), grad.float().reshape(-1, C))
    return out.view(B, num_points, C)


def _ball_query_group_backward_cuda(grad, idx, num_points):
    """The scatter on the card: kernel scatter_rows -> [B, N, C] of grad's
    dtype."""
    B, M, K, C = grad.shape
    return scatter_rows_cuda(GATHER, grad.reshape(B, M * K, C).contiguous(), num_points,
                             idx=idx.view(B, -1))


class _BallQueryGroup(torch.autograd.Function):
    """K4 forward; the backward scatters into the rows."""

    @staticmethod
    def forward(ctx, centers, points, rows, radius, num_neighbors):
        if kernels.on_card(centers):
            out, idx = _ball_query_group_cuda(centers, points, rows, radius, num_neighbors)
        else:
            out, idx = ball_query_group_plain(centers, points, rows, radius, num_neighbors)
        ctx.save_for_backward(idx)
        ctx.num_points = rows.shape[1]
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, grad, grad_idx=None):
        (idx,) = ctx.saved_tensors
        if kernels.on_card(grad):
            drows = _ball_query_group_backward_cuda(grad, idx, ctx.num_points)
        else:
            drows = ball_query_group_backward(grad, idx, ctx.num_points).to(grad.dtype)
        return None, None, drows, None, None


def ball_query_group(centers: torch.Tensor, points: torch.Tensor,
                     rows: torch.Tensor, radius: float, num_neighbors: int):
    """Radius query + row gather.

    Args:
      centers: [B, M, 3] query centres.
      points: [B, N, 3] selection coordinates.
      rows: [B, N, C] f32 or bf16 rows to gather (typically [coords | features]).
    Returns:
      (gathered [B, M, K, C] of rows' dtype, idx [B, M, K] int32)
    """
    return _BallQueryGroup.apply(centers, points, rows, radius, num_neighbors)
