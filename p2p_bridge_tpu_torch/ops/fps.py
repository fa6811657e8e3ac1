"""Furthest point sampling (port of p2p_bridge_tpu/ops/fps.py).

The first index is 0; every iteration updates the running point-to-set
squared distance against the last pick and takes the argmax, ties to the
lowest index. On a CUDA tensor :func:`furthest_point_sample` launches
kernel K5 (``csrc/fps.cu``): ``fps``, one warp per cloud up to 1,024
points and one block per cloud above, below :data:`CLUSTER_MIN_POINTS`
points a cloud (the SA stages, the bucketed recombination), and
``fps_cluster``, one cluster of 16 blocks per cloud, from there on (the
exact recombination, the seeding; it skips the passes of the units of
points a pick cannot reach, and :func:`cluster_skips` gets their count).
Both give the plain version's indices.
On a CPU tensor it runs the plain version.
:func:`furthest_point_sample_and_gather` gathers the picked coordinates.
:func:`bucket_fps` is the room path's host FPS over numpy, on the native
runtime.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..runtime import bucket_fps_host
from .common import batched_take


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


# From this many points a cloud the cluster kernel runs; the one-warp and
# one-block kernels take up to one point fewer. A lone cloud gains from
# 8,192 points on (chip_smoke.py's fps crossover, NVIDIA H100 80GB HBM3),
# but a batch does not: the one-block kernel runs up to 132 clouds at once,
# the cluster kernel a few 16-SM clusters, and at 73 clouds the one-block
# kernel is the faster up to 16,383 points. 16,384 takes the exact
# recombination (3 x a cloud's points) and the seeding of clouds from
# 16,384 points, and leaves every backbone FPS (at most 4,096 points in
# the three configs) to the one-warp and one-block kernels.
CLUSTER_MIN_POINTS = 16384


def cluster_skips(skipped: torch.Tensor, passes: int) -> torch.Tensor:
    """The cluster kernel's count of one call: ``skipped`` [B, 16] int64 on
    the card, each block's unit passes that its bounding-box test skipped,
    of ``passes`` a cloud (the units that hold points, times M - 1).
    Returns ``skipped``: nothing on the path reads it, so the count costs no
    sync; ``_fps_launch`` looks this function up in its module, where a
    profiling run can wrap it to read the counts after its window."""
    return skipped


def _fps_launch(kernel: str, coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Kernel ``fps`` (one warp or block per cloud, fewer than
    CLUSTER_MIN_POINTS points) or ``fps_cluster`` (one 16-block cluster per
    cloud) on coords [B, N, 3] f32 -> [B, M] int32."""
    B, N, _ = coords.shape
    device = kernels.check(("coords", coords, torch.float32, (B, N, 3)))
    if not 0 < num_samples <= N:
        raise ValueError(f"num_samples must be in [1, {N}], got {num_samples}")
    out = torch.empty((B, num_samples), dtype=torch.int32, device=coords.device)
    if kernel == "fps":  # the entry refuses N >= CLUSTER_MIN_POINTS
        kernels.launch(kernel, "p2pb_fps", device, coords.data_ptr(), B, N, num_samples,
                       out.data_ptr())
        return out
    entries = kernels.entry_points()
    nbytes = entries["p2pb_fps_cluster_scratch_bytes"](B, N)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=coords.device)
               if nbytes else None)
    skipped = torch.empty((B, 16), dtype=torch.int64, device=coords.device)
    passes = entries["p2pb_fps_cluster_units"](N) * (num_samples - 1)
    kernels.launch(
        kernel, "p2pb_fps_cluster", device, coords.data_ptr(), B, N, num_samples,
        None if scratch is None else scratch.data_ptr(), skipped.data_ptr(), out.data_ptr())
    cluster_skips(skipped, passes)
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


def furthest_point_sample_and_gather(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """FPS and the gather of the picked coordinates: [B, N, 3] -> [B, M, 3]
    (on the card, K5 and one gather)."""
    return batched_take(coords, furthest_point_sample(coords, num_samples))


def bucket_fps(points, num_samples: int, seed: int = 0) -> np.ndarray:
    """Approximate FPS for room-scale clouds on the host (port of
    p2p_bridge_tpu/ops/fps.py ``bucket_fps``): exact FPS over a strided
    candidate pool, in the native runtime. points [N, 3] numpy ->
    [min(num_samples, N)] int64 indices. ``seed`` is unused, as in the JAX
    package: the pool is deterministic, so calls that differ only in
    ``seed`` pick the same points."""
    points = np.asarray(points, dtype=np.float32)
    if num_samples >= points.shape[0]:
        return np.arange(points.shape[0], dtype=np.int64)
    return bucket_fps_host(points, num_samples)
