"""Furthest point sampling (port of p2p_bridge_tpu/ops/fps.py).

The first index is 0; every iteration updates the running point-to-set
squared distance against the last pick and takes the argmax, ties to the
lowest index. On a CUDA tensor :func:`furthest_point_sample` launches
kernel K5 (``csrc/fps.cu``): ``fps_kernel``, one block per cloud, below
:data:`CLUSTER_MIN_POINTS` points a cloud (the SA stages, the bucketed
recombination), and ``fps_cluster_kernel``, one cluster of 16 blocks per
cloud, from there on (the exact recombination, the seeding). Both give the
plain version's indices. On a CPU tensor it runs the plain version.
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


# From this many points a cloud the cluster kernel runs. A lone cloud
# gains from 4,096 points on (chip_smoke.py's fps crossover, NVIDIA H100),
# but a batch gains less: the one-block kernel runs up to 132 clouds at
# once, the cluster kernel a few 16-SM clusters (the crossover also times
# 73 clouds). 16,384 takes the exact recombination (3 x a cloud's points)
# and the seeding of clouds from 16,384 points, and leaves every backbone
# FPS (at most 4,096 points in the three configs) to the one-block kernel.
CLUSTER_MIN_POINTS = 16384


def _fps_launch(kernel: str, coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Kernel ``fps`` (one block per cloud) or ``fps_cluster`` (one
    16-block cluster per cloud) on coords [B, N, 3] f32 -> [B, M] int32."""
    B, N, _ = coords.shape
    device = kernels.check(("coords", coords, torch.float32, (B, N, 3)))
    if not 0 < num_samples <= N:
        raise ValueError(f"num_samples must be in [1, {N}], got {num_samples}")
    entry = f"p2pb_{kernel}"
    out = torch.empty((B, num_samples), dtype=torch.int32, device=coords.device)
    nbytes = kernels.entry_points()[entry + "_scratch_bytes"](B, N)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=coords.device)
               if nbytes else None)
    kernels.launch(
        kernel, entry, device, coords.data_ptr(), B, N, num_samples,
        None if scratch is None else scratch.data_ptr(), out.data_ptr())
    return out


def _furthest_point_sample_cuda(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """The kernel for the shape: the cluster kernel from CLUSTER_MIN_POINTS
    points a cloud. A cluster that cannot be resident raises."""
    kernel = "fps_cluster" if coords.shape[1] >= CLUSTER_MIN_POINTS else "fps"
    return _fps_launch(kernel, coords, num_samples)


def furthest_point_sample(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """FPS indices [B, M] int32 of coords [B, N, 3]."""
    if kernels.on_card(coords):
        return _furthest_point_sample_cuda(coords, num_samples)
    return furthest_point_sample_plain(coords, num_samples)
