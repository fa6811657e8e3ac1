"""Room patching and recomposition of P2P-Bridge (``denoise_room.py``) in
numpy and plain PyTorch, for the check of a room as the program served it.

Seeds: furthest point sampling over a strided pool of the room's points
(the published code's fpsample bucket FPS on a deterministic pool); their
radius neighbourhoods; each neighbourhood of n points padded with
jittered duplicates to the patch size (n < patch: rng.integers for the
duplicates, rng.normal at 1% of the neighbourhood's bounding-box diagonal
for the jitter, in patch order) or split into n // patch + 1 FPS subsets
of exactly the patch size. Each patch is denoised in its own frame (centre
the mean, scale the largest norm to 1), and every room point's prediction
is the mean over the patches that hold it in their first ``cut`` rows.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def fps_pool(n: int, m: int) -> np.ndarray:
    """The candidate pool of the bucket FPS of m picks from n points: every
    point where the pool would hold them all, else min(n, max(4 m, 4096))
    points at a stride of n / pool."""
    pool = min(n, max(4 * m, 4096))
    if pool >= n or m >= n:
        return np.arange(n)
    return (np.arange(pool) * (n / pool)).astype(np.int64)


def radius_neighbourhoods(points: torch.Tensor, centers: torch.Tensor, r: float) -> List[np.ndarray]:
    """Indices (ascending) of the points within r of each centre, in float64."""
    p = points.double()
    out = []
    for c in centers.double():
        d2 = ((p - c) ** 2).sum(dim=1)
        out.append(torch.nonzero(d2 <= r * r).flatten().cpu().numpy())
    return out


def patch_plan(room: np.ndarray, patch: int, neighbourhoods, split_picks, rng):
    """The patches the neighbourhoods give, with the split picks (one array
    of ``patch`` indices into the neighbourhood per FPS subset, in order)
    taken as given -> [(xyz [patch, 3] f32, room indices [patch], cut)]."""
    out = []
    picks = iter(split_picks)
    for mapping in neighbourhoods:
        n = len(mapping)
        if n == 0:
            continue
        xyz = room[mapping]
        diff = patch - n
        if diff > 0:
            ridx = rng.integers(0, n, diff)
            noise = np.linalg.norm(xyz.max(axis=0) - xyz.min(axis=0)) * 1e-2
            extra = xyz[ridx] + rng.normal(0, noise, (diff, 3))
            out.append((np.concatenate([xyz, extra]).astype(np.float32),
                        np.concatenate([mapping, mapping[ridx]]), n))
        else:
            for _ in range(n // patch + 1):
                sub = next(picks)
                out.append((xyz[sub].astype(np.float32), mapping[sub], patch))
    return out


def normalise(xyz: torch.Tensor):
    """(patches in their own frame, centres, scales) of [B, S, 3]."""
    center = xyz.mean(dim=1, keepdim=True)
    rel = xyz - center
    scale = torch.linalg.norm(rel, dim=2, keepdim=True).amax(dim=1, keepdim=True)
    return rel / scale, center, scale


def recompose(n_points: int, preds: torch.Tensor, idxs: np.ndarray, cuts: np.ndarray):
    """(sums [N, 3] f64, counts [N]) of the predictions [P, S, 3] over the
    first cut rows of each patch."""
    sums = torch.zeros((n_points, 3), dtype=torch.float64, device=preds.device)
    counts = torch.zeros(n_points, dtype=torch.float64, device=preds.device)
    for p in range(preds.shape[0]):
        rows = torch.from_numpy(np.asarray(idxs[p][:cuts[p]])).to(preds.device)
        sums.index_add_(0, rows, preds[p, :cuts[p]].double())
        counts.index_add_(0, rows, torch.ones(len(rows), dtype=torch.float64, device=preds.device))
    return sums, counts
