"""Nearest-point distances, and the furthest point sampling certificate.

``cover_excess``: the certificate of a furthest point sampling.
Picking N points of a set by FPS leaves every point of the set within the
(N + 1)-th pick's distance of the picks, which is at most the smallest
distance between two picks. So the largest distance from a reference
point to the nearest pick, over the smallest distance between picks, is
at most 1 plus the drift over that spacing; ``cover_excess`` is that
ratio less 1. A selection that is not furthest point sampling (or that
leaves part of the cloud out) covers the cloud much worse than its
spacing.
"""

from __future__ import annotations

import torch

CHUNK_ELEMENTS = 2 ** 28  # distances held at once (1 GiB of f32)


def nearest(query: torch.Tensor, points: torch.Tensor, exclude_self: bool = False) -> torch.Tensor:
    """Distance [M] from each query point [M, 3] to the nearest of points
    [N, 3], from coordinate differences (no cancellation); with
    ``exclude_self`` (query is points) each point's own entry is left out."""
    out = torch.empty(query.shape[0], device=query.device)
    chunk = max(1, CHUNK_ELEMENTS // points.shape[0])
    for a in range(0, query.shape[0], chunk):
        d = torch.cdist(query[a:a + chunk].float(), points.float(),
                        compute_mode="donot_use_mm_for_euclid_dist")
        if exclude_self:
            rows = torch.arange(d.shape[0], device=d.device)
            d[rows, rows + a] = float("inf")
        out[a:a + chunk] = d.min(dim=1).values
    return out


def cover_excess(picks: torch.Tensor, reference: torch.Tensor) -> float:
    cover = nearest(reference, picks).max()
    spacing = nearest(picks, picks, exclude_self=True).min()
    return float(cover / spacing - 1.0)
