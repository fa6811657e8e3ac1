"""Metrics of the port: the auction EMD (kernel K7) and the alignment it
serves in training; Chamfer, point <-> mesh distance and the room
evaluation's facade (plain PyTorch)."""

from .chamfer import chamfer_distance, chamfer_distance_large
from .emd_auction import align_clean_to_noisy, auction_emd, auction_emd_plain
from .metrics import cd_large_pair, cd_unit_sphere, normalize_pcl, normalize_sphere, point_face_dist
from .p2m import point_mesh_face_distance, point_triangle_sqdist

__all__ = [
    "align_clean_to_noisy", "auction_emd", "auction_emd_plain", "cd_large_pair",
    "cd_unit_sphere", "chamfer_distance", "chamfer_distance_large", "normalize_pcl",
    "normalize_sphere", "point_face_dist", "point_mesh_face_distance", "point_triangle_sqdist",
]
