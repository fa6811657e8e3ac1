"""Metrics of the port: the auction EMD (kernel K7) and the alignment it
serves in training; Chamfer, the approximate EMD, point <-> mesh distance
and the facade of the object and room evaluations (plain PyTorch)."""

from .chamfer import chamfer_distance, chamfer_distance_large
from .emd_approx import approx_match, earth_mover_distance, match_cost
from .emd_auction import align_clean_to_noisy, auction_emd, auction_emd_plain
from .metrics import (calculate_cd, calculate_cd_cuda, calculate_emd, calculate_emd_cuda,
                      calculate_emd_exact, calculate_emd_exact_cuda, cd_large_pair,
                      cd_unit_sphere, normalize_pcl, normalize_sphere, point_face_dist)
from .p2m import point_mesh_face_distance, point_triangle_sqdist

__all__ = [
    "align_clean_to_noisy", "approx_match", "auction_emd", "auction_emd_plain",
    "calculate_cd", "calculate_cd_cuda", "calculate_emd", "calculate_emd_cuda",
    "calculate_emd_exact", "calculate_emd_exact_cuda", "cd_large_pair", "cd_unit_sphere",
    "chamfer_distance", "chamfer_distance_large", "earth_mover_distance", "match_cost",
    "normalize_pcl", "normalize_sphere", "point_face_dist", "point_mesh_face_distance",
    "point_triangle_sqdist",
]
