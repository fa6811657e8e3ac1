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

:func:`ball_query_group_rel` is the set-abstraction module's form: it takes
the coordinates and the features apart and returns the grouped tensor
``[points[idx] - centre | features[idx]]`` in the features' dtype, what
the module's composition (``cat`` of coordinates and features, gather,
subtract, ``cat``) gives, in one launch of K4 on the card.
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


MAX_NEIGHBORS = 128  # a block keeps its 64 centres' indices in shared memory


def check_ball_query_shape(B: int, K: int, W: int) -> None:
    """Raise unless the kernel takes B clouds with K neighbours of output
    rows of W elements: 1 <= B < 65536 (the grid's second dimension),
    1 <= K <= 128 (shared memory) and 64 * K * W below 2^31 (a block's
    32-bit offsets). Every call of the three configs qualifies (K = 32,
    W <= 579)."""
    if not (1 <= B < 2 ** 16 and 1 <= K <= MAX_NEIGHBORS and 64 * K * W < 2 ** 31):
        raise ValueError(f"ball_query_group kernel takes 1 <= B < 65536, 1 <= K <= "
                         f"{MAX_NEIGHBORS} and 64 * K * W < 2^31; got B={B}, K={K}, W={W}")


def _ball_query_group_cuda(centers, points, rows, radius, num_neighbors, rel=False):
    """K4 on the card: rows [B, N, C] gathered as they are, or with ``rel``
    (rows are then the features) behind the centre-relative coordinates."""
    B, M, _ = centers.shape
    N, C, K = points.shape[1], rows.shape[-1], num_neighbors
    device = kernels.check(("centers", centers, torch.float32, (B, M, 3)),
                           ("points", points, torch.float32, (B, N, 3)),
                           ("rows", rows, kernels.DATA, (B, N, C)))
    W = C + 3 if rel else C
    check_ball_query_shape(B, K, W)
    out = rows.new_empty((B, M, K, W))
    idx = centers.new_empty((B, M, K), dtype=torch.int32)
    kernels.launch(
        "ball_query_group", "p2pb_ball_query_group_rel" if rel else "p2pb_ball_query_group",
        device, centers.data_ptr(), points.data_ptr(), rows.data_ptr(), B, M, N, C, K,
        _radius_sq(radius), int(rows.dtype == torch.bfloat16), out.data_ptr(), idx.data_ptr())
    return out, idx


def ball_query_group_rel_plain(centers, points, features, radius, num_neighbors):
    """The set-abstraction module's composition: [points[idx] - centre |
    features[idx]] in the features' dtype T, the coordinates rounded to T
    before the subtraction, and idx."""
    idx = ball_query(centers, points, radius, num_neighbors)
    dt = features.dtype
    rel = batched_take(points.to(dt), idx) - centers.to(dt)[:, :, None, :]
    return torch.cat([rel, batched_take(features, idx)], dim=-1), idx


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


def _scatter(grad, idx, num_points):
    """The gathered rows' gradient [B, M, K, C] into [B, N, C] of grad's
    dtype: kernel scatter_rows on the card, else the plain version."""
    if kernels.on_card(grad):
        return _ball_query_group_backward_cuda(grad, idx, num_points)
    return ball_query_group_backward(grad, idx, num_points).to(grad.dtype)


def _forward(centers, points, rows, radius, num_neighbors, rel):
    if kernels.on_card(centers):
        return _ball_query_group_cuda(centers, points, rows, radius, num_neighbors, rel)
    plain = ball_query_group_rel_plain if rel else ball_query_group_plain
    return plain(centers, points, rows, radius, num_neighbors)


class _BallQueryGroup(torch.autograd.Function):
    """K4 forward; the backward scatters into the rows."""

    @staticmethod
    def forward(ctx, centers, points, rows, radius, num_neighbors):
        out, idx = _forward(centers, points, rows, radius, num_neighbors, False)
        ctx.save_for_backward(idx)
        ctx.num_points = rows.shape[1]
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, grad, grad_idx=None):
        (idx,) = ctx.saved_tensors
        return None, None, _scatter(grad, idx, ctx.num_points), None, None


class _BallQueryGroupRel(torch.autograd.Function):
    """K4's set-abstraction form. The backward is the composition's: the
    features get the scatter of grad[..., 3:] (scatter_rows sums each
    channel on its own, so this is the composition's rows gradient without
    its first three columns); where they ask for one, the points get the
    scatter of grad[..., :3] and the centres -sum_k grad[..., :3], both in
    the features' dtype, then f32."""

    @staticmethod
    def forward(ctx, centers, points, features, radius, num_neighbors):
        out, idx = _forward(centers, points, features, radius, num_neighbors, True)
        ctx.save_for_backward(idx)
        ctx.num_points = points.shape[1]
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, grad, grad_idx=None):
        (idx,) = ctx.saved_tensors
        need_c, need_p, need_f = ctx.needs_input_grad[:3]
        dc = dp = df = None
        if need_f:
            df = _scatter(grad[..., 3:], idx, ctx.num_points)
        if need_p:
            dp = _scatter(grad[..., :3], idx, ctx.num_points).float()
        if need_c:
            dc = (-grad[..., :3]).sum(dim=2).float()
        return dc, dp, df, None, None


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    if _records(rows):
        return _BallQueryGroup.apply(centers, points, rows, radius, num_neighbors)
    return _forward(centers, points, rows, radius, num_neighbors, False)


def ball_query_group_rel(centers: torch.Tensor, points: torch.Tensor,
                         features: torch.Tensor, radius: float, num_neighbors: int):
    """Radius query + the set-abstraction module's grouping.

    Args:
      centers: [B, M, 3] f32 query centres.
      points: [B, N, 3] f32 coordinates, for the selection and the offsets.
      features: [B, N, C] f32 or bf16.
    Returns:
      (grouped [B, M, K, 3 + C] of features' dtype T: round_T(round_T(p) -
      round_T(centre)) then the features, for each selected point p;
      idx [B, M, K] int32)
    """
    if _records(centers, points, features):
        return _BallQueryGroupRel.apply(centers, points, features, radius, num_neighbors)
    return _forward(centers, points, features, radius, num_neighbors, True)
