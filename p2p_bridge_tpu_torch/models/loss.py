"""Losses (port of p2p_bridge_tpu/models/loss.py).

Every loss maps (pred [B, ...], gt [B, ...]) to a per-cloud loss [B]; the
bridge applies the SNR weighting and the final mean.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..metrics.emd_auction import auction_emd


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).reshape(pred.shape[0], -1).mean(dim=-1)


def mse_sum(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).reshape(pred.shape[0], -1).sum(dim=-1)


def l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().reshape(pred.shape[0], -1).mean(dim=-1)


def emd(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Auction EMD (eps 0.005, 50 rounds): the mean over points of the
    square root of each matched squared distance. As in the JAX package the
    distances come from the auction, which has no gradient."""
    dist, _ = auction_emd(pred, gt, eps=0.005, iters=50)
    return torch.sqrt(dist).mean(dim=-1)


LOSSES = {"mse": mse, "mse_sum": mse_sum, "l1": l1, "emd": emd}


def get_loss(loss_type: str) -> Callable:
    if loss_type not in LOSSES:
        raise ValueError(f"unknown loss type: {loss_type}")
    return LOSSES[loss_type]
