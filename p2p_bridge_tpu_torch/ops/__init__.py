"""Point-cloud ops of the port, channels-last like the JAX package
(``[B, N, C]`` points, ``[B, r, r, r, C]`` grids).

The plain ``ball_query``, the fused ``conv3d_gn`` and
``three_nn_interpolate`` (which also returns the weights and indices) are
reached through their modules (``ops.ball_query``, ``ops.conv3d_gn``,
``ops.interpolate``)."""

from .ball_query import ball_query_group, ball_query_group_rel
from .common import (batched_take, pairwise_sqdist, pairwise_sqdist_exact,
                     pairwise_sqdist_ordered)
from .devoxelize import trilinear_devoxelize, trilinear_devoxelize_with_mean
from .fps import furthest_point_sample, furthest_point_sample_and_gather
from .interpolate import nearest_neighbor_interpolate, three_nn
from .knn import knn
from .voxelize import avg_voxelize, flat_voxel_index, normalize_coords_to_voxels

__all__ = [
    "avg_voxelize", "ball_query_group", "ball_query_group_rel", "batched_take",
    "flat_voxel_index", "furthest_point_sample", "furthest_point_sample_and_gather", "knn", "nearest_neighbor_interpolate",
    "normalize_coords_to_voxels", "pairwise_sqdist", "pairwise_sqdist_exact",
    "pairwise_sqdist_ordered", "three_nn", "trilinear_devoxelize", "trilinear_devoxelize_with_mean",
]
