"""Point-to-mesh distances (port of p2p_bridge_tpu/metrics/p2m.py), plain
PyTorch: bidirectional point <-> triangle squared distances.

The distance to a triangle is closed form (the projection into the plane
when it falls inside, else the nearest of the three edges). Candidates come
from a scipy cKDTree on the host, as in the JAX package: the K faces whose
centroids lie nearest each point, and the K points nearest each face's
centroid; the exact distances to those candidates are computed on
``device``. Exact when the true nearest face (point) is among the K
candidates (K = 32 by default).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..utils.device import resolve_device


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def point_triangle_sqdist(p, v0, v1, v2):
    """Exact squared distance from points to triangles (broadcasting).

    Args:
      p: [..., 3]; v0/v1/v2: [..., 3] triangle vertices.
    Returns:
      [...] squared distances.
    """
    e0 = v1 - v0
    e1 = v2 - v0
    d = p - v0
    a = _dot(e0, e0)
    b = _dot(e0, e1)
    c = _dot(e1, e1)
    d0 = _dot(e0, d)
    d1 = _dot(e1, d)
    det = a * c - b * b

    # barycentric coordinates of the projection into the plane
    degenerate = torch.abs(det) < 1e-20
    safe_det = torch.where(degenerate, torch.ones_like(det), det)
    s = (c * d0 - b * d1) / safe_det
    t = (a * d1 - b * d0) / safe_det
    inside = (s >= 0) & (t >= 0) & (s + t <= 1) & ~degenerate
    proj = v0 + s[..., None] * e0 + t[..., None] * e1
    d_in = _dot(p - proj, p - proj)

    def seg_sqdist(a_pt, b_pt):
        ab = b_pt - a_pt
        tt = torch.clamp(_dot(p - a_pt, ab) / torch.clamp(_dot(ab, ab), min=1e-20), 0, 1)
        q = a_pt + tt[..., None] * ab
        return _dot(p - q, p - q)

    d_edge = torch.minimum(torch.minimum(seg_sqdist(v0, v1), seg_sqdist(v0, v2)),
                           seg_sqdist(v1, v2))
    return torch.where(inside, d_in, d_edge)


def point_mesh_face_distance(points: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                             k_candidates: int = 32, chunk: int = 131072, device="cuda"):
    """Bidirectional point <-> mesh-face squared distances.

    Args:
      points: [P, 3]; verts: [V, 3]; faces: [F, 3] int vertex indices.
      device: where the candidate distances are computed; "cuda" with no
        card raises.
    Returns:
      (point_dist: mean over points of the min over faces,
       face_dist: mean over faces of the min over points), floats.
    """
    device = resolve_device(device)
    points = np.asarray(points, np.float32)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    tris = verts[faces]  # [F, 3, 3]
    centroids = tris.mean(axis=1)

    def on_device(a):
        return torch.as_tensor(a, device=device)

    # point -> nearest face: candidates are the faces of the k nearest centroids
    k = min(k_candidates, len(centroids))
    tree = cKDTree(centroids)
    dists = []
    for s in range(0, len(points), chunk):
        pc = points[s:s + chunk]
        _, cand = tree.query(pc, k=k)
        tv = on_device(tris[cand.reshape(len(pc), k)])  # [Pc, k, 3, 3]
        d = point_triangle_sqdist(on_device(pc)[:, None, :], tv[:, :, 0], tv[:, :, 1],
                                  tv[:, :, 2])
        dists.append(d.min(dim=1).values.cpu().numpy())
    point_dist = float(np.concatenate(dists).mean())

    # face -> nearest point: candidates are the k points nearest the centroid
    kp = min(k_candidates, len(points))
    ptree = cKDTree(points)
    fdists = []
    for s in range(0, len(tris), chunk):
        tc = tris[s:s + chunk]
        _, cand = ptree.query(tc.mean(axis=1), k=kp)
        tv = on_device(tc)
        d = point_triangle_sqdist(on_device(points[cand.reshape(len(tc), kp)]),
                                  tv[:, None, 0], tv[:, None, 1], tv[:, None, 2])
        fdists.append(d.min(dim=1).values.cpu().numpy())
    face_dist = float(np.concatenate(fdists).mean())
    return point_dist, face_dist
