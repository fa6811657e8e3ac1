"""Furthest point sampling (port of p2p_bridge_tpu/ops/fps.py).

The first index is 0; every iteration updates the running point-to-set
squared distance against the last pick and takes the argmax, ties to the
lowest index. On a CUDA tensor :func:`furthest_point_sample` launches
kernel K5 (``csrc/fps.cu``); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels


def furthest_point_sample_plain(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch FPS: [B, N, 3] -> [B, M] int32."""
    coords = coords.float()
    B, N, _ = coords.shape
    x, y, z = coords.unbind(-1)
    dists = torch.full((B, N), torch.finfo(torch.float32).max, device=coords.device)
    out = torch.zeros((B, num_samples), dtype=torch.int32, device=coords.device)
    bidx = torch.arange(B, device=coords.device)
    last = torch.zeros(B, dtype=torch.long, device=coords.device)
    for j in range(1, num_samples):
        p = coords[bidx, last]  # [B, 3]
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        dists = torch.minimum(dists, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(dists, dim=-1)  # first maximum
        out[:, j] = last.int()
    return out


def _furthest_point_sample_cuda(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    B, N, _ = coords.shape
    device = kernels.check(("coords", coords, torch.float32, (B, N, 3)))
    if not 0 < num_samples <= N:
        raise ValueError(f"num_samples must be in [1, {N}], got {num_samples}")
    out = torch.empty((B, num_samples), dtype=torch.int32, device=coords.device)
    nbytes = kernels.entry_points()["p2pb_fps_scratch_bytes"](B, N)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=coords.device)
               if nbytes else None)
    kernels.launch(
        "fps", "p2pb_fps", device, coords.data_ptr(), B, N, num_samples,
        None if scratch is None else scratch.data_ptr(), out.data_ptr())
    return out


def furthest_point_sample(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """FPS indices [B, M] int32 of coords [B, N, 3]."""
    if kernels.on_card(coords):
        return _furthest_point_sample_cuda(coords, num_samples)
    return furthest_point_sample_plain(coords, num_samples)
