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

The backward is the JAX package's (interpolate.py ``_nn_interp_fused_bwd``,
the CUDA backward): d_features = W^T g, each point's weighted gradient
added into its three centres (in f32, rounded once to the features'
dtype); the weights are stop-gradient, so points and centres get no
gradient. On a CUDA tensor it is kernel ``scatter_rows``
(``ops/scatter.py``), bit-equal to the plain version (``index_add_``) run
on the CPU. Under grad the forward asks K6 for its weights and indices;
without grad it skips those stores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .common import batched_take, pairwise_sqdist_exact
from .scatter import INTERP, scatter_rows_cuda


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
    device = kernels.check(("points", points, torch.float32, (B, N, 3)),
                           ("centers", centers, torch.float32, (B, M, 3)),
                           ("features", features, kernels.DATA, (B, M, C)))
    dev, dt = points.device, features.dtype
    if M < 1:
        raise ValueError("three_nn_interpolate needs at least one centre")
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    w = idx = None
    if with_weights:
        w = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
        idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    kernels.launch(
        "three_nn_interpolate", "p2pb_three_nn_interpolate", device, points.data_ptr(),
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


def three_nn_interpolate_backward(grad: torch.Tensor, weights: torch.Tensor,
                                  idx: torch.Tensor, num_centers: int) -> torch.Tensor:
    """The plain scatter: grad [B, N, C], weights and indices [B, N, 3] ->
    d_features [B, M, C] f32 = W^T grad, added with index_add_ in (n, j)
    order."""
    B, N, C = grad.shape
    base = (torch.arange(B, device=grad.device) * num_centers)[:, None, None]
    src = weights.float()[..., None] * grad.float()[:, :, None, :]  # [B, N, 3, C]
    out = torch.zeros((B * num_centers, C), dtype=torch.float32, device=grad.device)
    out.index_add_(0, (idx.long() + base).reshape(-1), src.reshape(-1, C))
    return out.view(B, num_centers, C)


def _three_nn_interpolate_backward_cuda(grad, weights, idx, num_centers):
    """W^T grad on the card: kernel scatter_rows -> [B, M, C] of grad's
    dtype."""
    B = grad.shape[0]
    return scatter_rows_cuda(INTERP, grad.contiguous(), num_centers, idx=idx.view(B, -1),
                             weights=weights.view(B, -1))


class _ThreeNNInterpolate(torch.autograd.Function):
    """K6 forward with weights and indices; the backward is W^T g."""

    @staticmethod
    def forward(ctx, points, centers, features):
        out, w, idx = three_nn_interpolate(points, centers, features, with_weights=True)
        ctx.save_for_backward(w, idx)
        ctx.num_centers = centers.shape[1]
        return out

    @staticmethod
    def backward(ctx, grad):
        w, idx = ctx.saved_tensors
        if kernels.on_card(grad):
            dfeat = _three_nn_interpolate_backward_cuda(grad, w, idx, ctx.num_centers)
        else:
            dfeat = three_nn_interpolate_backward(grad, w, idx, ctx.num_centers).to(grad.dtype)
        return None, None, dfeat


def nearest_neighbor_interpolate(points: torch.Tensor, centers: torch.Tensor,
                                 features: torch.Tensor) -> torch.Tensor:
    """Fine points [B, N, 3], coarse centres [B, M, 3] and features
    [B, M, C] -> [B, N, C]."""
    if torch.is_grad_enabled() and features.requires_grad:
        return _ThreeNNInterpolate.apply(points, centers, features)
    return three_nn_interpolate(points, centers, features, with_weights=False)[0]
