"""Patch-based object denoising (port of p2p_bridge_tpu/inference.py).

FPS seeds -> kNN patches -> joint normalisation -> bridge sampling over all
patches as one batch -> FPS back down to N points, exact (one global FPS,
the reference's semantics) or bucketed (an equal FPS quota per patch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops import batched_take, furthest_point_sample, knn


def normalize_unit_sphere(pcl: np.ndarray, center=None, scale=None):
    """Bounding-box centre and max-norm scale of a cloud [N, 3] (a copy of
    p2p_bridge_tpu/data/transforms.py:normalize_unit_sphere) ->
    (normalised cloud, center [1, 3], scale)."""
    if center is None:
        center = (pcl.max(axis=0, keepdims=True) + pcl.min(axis=0, keepdims=True)) / 2
    pcl = pcl - center
    if scale is None:
        scale = np.sqrt((pcl**2).sum(axis=1)).max()
    return pcl / scale, center, scale


def _denoise_one(bridge, pcl: torch.Tensor, patch_size: int, num_seeds: int,
                 steps: int, clip_denoise: bool, save_intermediate: bool):
    """pcl [1, N, 3] -> (flat denoised [1, S*K, 3], chain [T, S*K, 3] or None)."""
    seeds = batched_take(pcl, furthest_point_sample(pcl, num_seeds))  # [1, S, 3]
    _, idx = knn(seeds, pcl, patch_size)  # [1, S, K]
    patches = pcl[0][idx[0].long()]  # [S, K, 3]

    # joint normalisation: per-patch centre, one global scale
    centers = patches.mean(dim=1, keepdim=True)
    patches = patches - centers
    scale = torch.linalg.norm(patches, dim=-1).max()
    patches = patches / scale

    out = bridge.sample(patches.contiguous(), steps=steps, clip_denoise=clip_denoise,
                        log_count=steps)
    flat = (out["x_pred"] * scale + centers).reshape(1, -1, 3)
    chain = None
    if save_intermediate:
        c = out["x_chain"] * scale + centers[:, None]  # [S, T, K, 3]
        chain = c.transpose(0, 1).reshape(c.shape[1], -1, 3)  # [T, S*K, 3]
    return flat, chain


def recombine_exact(flats: torch.Tensor, n: int) -> torch.Tensor:
    """[O, S*K, 3] -> [O, N, 3] by one global FPS per cloud."""
    return batched_take(flats, furthest_point_sample(flats.contiguous(), n))


def recombine_bucketed(flats: torch.Tensor, n: int, num_patches: int,
                       patch_size: int) -> torch.Tensor:
    """[O, S*K, 3] -> [O, N, 3] by an FPS quota of ceil(N / S) per patch;
    the surplus drops the last-ranked picks of the highest patches."""
    O = flats.shape[0]
    per = -(-n // num_patches)
    pp = flats.reshape(O * num_patches, patch_size, 3).contiguous()
    picked = batched_take(pp, furthest_point_sample(pp, per))  # [O*S, per, 3]
    picked = picked.reshape(O, num_patches, per, 3).transpose(1, 2)
    return picked.reshape(O, num_patches * per, 3)[:, :n]


@torch.no_grad()
def patch_based_denoise_batch(
    bridge,
    pcls: np.ndarray,
    patch_size: int = 2048,
    seed_k: int = 3,
    steps: int = 5,
    clip_denoise: bool = False,
    save_intermediate: bool = False,
    recombine_mode: str = "exact",
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Denoise a batch of unit-sphere-normalised object clouds.

    Args:
      bridge: a P2PBridge whose model lives on ``device``.
      pcls: [O, N, 3].
      recombine_mode: "exact" or "bucketed".
      device: where to run (default: the device of the bridge's model).
    Returns:
      (denoised [O, N, 3], steps [O, T, N, 3] or None)
    """
    if recombine_mode not in ("exact", "bucketed"):
        raise ValueError(f"recombine_mode must be 'exact' or 'bucketed', got {recombine_mode!r}")
    if device is None:
        device = next(bridge.model.parameters()).device
    pcls = np.asarray(pcls, np.float32)
    O, N = int(pcls.shape[0]), int(pcls.shape[1])
    num_seeds = int(seed_k * N / patch_size)

    flats, chains = [], []
    for o in range(O):
        pcl = torch.from_numpy(pcls[o][None]).to(device)
        flat, chain = _denoise_one(bridge, pcl, patch_size, num_seeds, steps,
                                   clip_denoise, save_intermediate)
        flats.append(flat)
        if chain is not None:
            chains.append(chain)

    def recombine(x):
        if recombine_mode == "bucketed":
            return recombine_bucketed(x, N, num_seeds, patch_size)
        return recombine_exact(x, N)

    denoised = recombine(torch.cat(flats, dim=0))
    steps_out = None
    if chains:
        stacked = torch.cat(chains, dim=0)  # [O*T, S*K, 3]
        T = chains[0].shape[0]
        steps_out = recombine(stacked).reshape(O, T, N, 3).cpu().numpy()
    return denoised.cpu().numpy(), steps_out


def patch_based_denoise(bridge, pcl_noisy: np.ndarray, patch_size: int = 2048,
                        seed_k: int = 3, steps: int = 5, clip_denoise: bool = False,
                        save_intermediate: bool = False, recombine_mode: str = "exact",
                        device: Optional[torch.device] = None):
    """Denoise one normalised cloud [N, 3] -> (denoised [N, 3], steps
    [T, N, 3] or None)."""
    denoised, chain = patch_based_denoise_batch(
        bridge, np.asarray(pcl_noisy, np.float32)[None], patch_size=patch_size,
        seed_k=seed_k, steps=steps, clip_denoise=clip_denoise,
        save_intermediate=save_intermediate, recombine_mode=recombine_mode,
        device=device)
    return denoised[0], (None if chain is None else chain[0])
