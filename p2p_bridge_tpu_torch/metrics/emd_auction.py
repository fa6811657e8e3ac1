"""Assignment EMD by the auction algorithm (port of
p2p_bridge_tpu/metrics/emd_auction.py).

A Jacobi auction: each round every point that owns no object bids
(best value - second value + eps) on its best object, value = -d2 - price;
each object takes its highest bid (ties to the lowest point index), raises
its price by it and evicts its previous owner. Rounds stop when every point
owns an object or after ``iters`` rounds; a point left unowned takes its
best object at the final prices. As in the reference the result
approximates a bijection. It serves the PUNet training alignment (eps 0.01,
100 rounds) and the EMD loss (eps 0.005, 50 rounds).

On a CUDA tensor :func:`auction_emd_assign` launches kernel K7
(``csrc/auction.cu``), which returns exactly the plain version's
assignment and distances for the same ``d2``; on a CPU tensor it runs
:func:`auction_emd_plain`, the JAX package's ``_auction_emd_xla`` step for
step. Neither is differentiable: the assignment is integer and the
distances are read from ``d2``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops.common import pairwise_sqdist

NEG = -1e30


def auction_emd_plain(d2: torch.Tensor, eps: float, iters: int):
    """d2 [B, N, M] f32 -> (dist [B, N] f32, assign [B, N] int32), in the
    f32 operations and order of ``_auction_emd_xla``. A cloud whose loop
    has ended keeps its state while others go on, as under jax.vmap."""
    d2 = d2.float()
    B, N, M = d2.shape
    dev = d2.device
    eps = torch.tensor(eps, dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    points = torch.arange(N, device=dev).expand(B, N)
    objects = torch.arange(M, device=dev).expand(B, M)
    assign = torch.full((B, N), -1, dtype=torch.long, device=dev)
    price = torch.zeros((B, M), dtype=torch.float32, device=dev)
    for _ in range(iters):
        active = (assign < 0).any(dim=1)  # [B]
        if not bool(active.any()):
            break
        value = -d2 - price[:, None, :]
        best = torch.argmax(value, dim=2)  # first occurrence
        v1 = torch.gather(value, 2, best[..., None])[..., 0]
        v2 = value.scatter_(2, best[..., None], NEG).amax(dim=2)
        del value
        incr = (v1 - v2) + eps
        bidding = assign < 0
        bid = torch.where(bidding, incr, neg)
        win_bid = torch.full((B, M), NEG, device=dev).scatter_reduce(
            1, best, bid, "amax", include_self=True)
        has_bid = win_bid > NEG / 2
        is_win_bid = bidding & (bid == torch.gather(win_bid, 1, best))
        winner = torch.full((B, M), N, device=dev).scatter_reduce(
            1, best, torch.where(is_win_bid, points, N), "amin", include_self=True)
        new_price = torch.where(has_bid, price + win_bid, price)
        rebid = torch.gather(has_bid, 1, assign.clamp(min=0)) & (assign >= 0)
        new_assign = torch.where(rebid, -1, assign)
        won = has_bid & (winner < N)
        slot = torch.where(won, winner, N)  # N: dropped
        is_winner = torch.zeros((B, N + 1), dtype=torch.bool, device=dev).scatter_(
            1, slot, True)[:, :N]
        new_obj = torch.full((B, N + 1), -1, dtype=torch.long, device=dev).scatter_(
            1, slot, objects)[:, :N]
        new_assign = torch.where(is_winner, new_obj, new_assign)
        price = torch.where(active[:, None], new_price, price)
        assign = torch.where(active[:, None], new_assign, assign)
    fallback = torch.argmax(-d2 - price[:, None, :], dim=2)
    assign = torch.where(assign < 0, fallback, assign)
    dist = torch.gather(d2, 2, assign[..., None])[..., 0]
    return dist, assign.int()


def _auction_emd_cuda(d2: torch.Tensor, eps: float, iters: int):
    """(dist, assign, stats [B, 3] int32: rounds run, bidder rows read,
    points left to the greedy fallback)."""
    B, N, M = d2.shape
    device = kernels.check(("d2", d2, torch.float32, (B, N, M)))
    dev = d2.device
    smem = kernels.entry_points()["p2pb_auction_smem_bytes"](N, M)
    if smem > 232_448:
        raise ValueError(f"auction_emd: N={N}, M={M} need {smem} bytes of shared memory")
    if N < 1 or M < 1:
        raise ValueError("auction_emd needs at least one point and one object")
    assign = torch.empty((B, N), dtype=torch.int32, device=dev)
    dist = torch.empty((B, N), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 3), dtype=torch.int32, device=dev)
    kernels.launch("auction_emd", "p2pb_auction_emd", device, d2.data_ptr(), B, N, M,
                   float(eps), int(iters), assign.data_ptr(), dist.data_ptr(),
                   stats.data_ptr())
    return dist, assign, stats


def auction_emd_assign(d2: torch.Tensor, eps: float, iters: int):
    """Auction over a cost matrix d2 [B, N, M] f32 -> (dist [B, N] f32,
    assign [B, N] int32): kernel K7 on a CUDA tensor, the plain version on
    a CPU tensor."""
    d2 = d2.detach()
    if kernels.on_card(d2):
        return _auction_emd_cuda(d2.float().contiguous(), eps, iters)[:2]
    return auction_emd_plain(d2, eps, iters)


def auction_emd(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50):
    """Auction assignment from xyz1 [B, N, 3] onto xyz2 [B, M, 3] ->
    (dist [B, N] squared distances of the matched pairs, assign [B, N]
    int32 indices into xyz2), on the expanded-form distances of
    :func:`pairwise_sqdist`."""
    return auction_emd_assign(pairwise_sqdist(xyz1.detach(), xyz2.detach()), eps, iters)


def align_clean_to_noisy(noisy: torch.Tensor, clean: torch.Tensor, eps: float = 0.005,
                         iters: int = 50) -> torch.Tensor:
    """``clean`` [B, N, 3] re-ordered so that clean[i] is matched to
    noisy[i] (the auction from noisy onto clean, then a gather)."""
    _, assign = auction_emd(noisy, clean, eps=eps, iters=iters)
    return torch.gather(clean, 1, assign.long()[..., None].expand(-1, -1, clean.shape[-1]))
