"""Inputs made from the seed: object surfaces and ScanNet++-like rooms
(numpy on the host).

Objects: a bumpy sphere, an ellipsoid and a torus sampled uniformly in
their parameters, as the PU-Net protocol's meshes are sampled to 10,000
and 50,000 points; the noisy cloud adds gaussian noise of sigma (a share
of the unit sphere) and is normalised as ``evaluate_objects`` normalises
its inputs (bounding-box centre, largest norm 1).

Rooms: a 4 x 4 m floor with two each of boxes, spheres and cylinders
standing on it, sampled uniformly over the area, gaussian noise and a
share of outliers, as an iPhone scan of ScanNet++ is noisy.
"""

from __future__ import annotations

import numpy as np

def shape(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n clean points [n, 3] of the surface, centred, largest norm 1."""
    if kind == "torus":
        u, v = rng.uniform(0, 2 * np.pi, (2, n))
        p = np.stack([(0.7 + 0.3 * np.cos(v)) * np.cos(u),
                      (0.7 + 0.3 * np.cos(v)) * np.sin(u), 0.3 * np.sin(v)], 1)
    elif kind in ("ellipsoid", "bumpy_sphere"):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        if kind == "ellipsoid":
            p = d * np.array([1.0, 0.7, 0.5])
        else:
            p = d * (1.0 + 0.15 * np.sin(3 * d[:, :1]) * np.cos(2 * d[:, 1:2]))
    else:
        raise ValueError(f"unknown shape {kind!r}")
    p -= p.mean(0)
    return p / np.linalg.norm(p, axis=1).max()


def normalize(pcl: np.ndarray) -> np.ndarray:
    """Bounding-box centre to the origin, largest norm 1."""
    pcl = pcl - (pcl.max(axis=0, keepdims=True) + pcl.min(axis=0, keepdims=True)) / 2
    return pcl / np.sqrt((pcl ** 2).sum(axis=1)).max()


def noisy_object(kind: str, n: int, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """A noisy scan [n, 3] f32 of the surface, normalised."""
    p = shape(kind, n, rng)
    return normalize(p + sigma * rng.normal(size=p.shape)).astype(np.float32)


def _grid_surface(nu: int, nv: int, point):
    u, v = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    verts = np.stack(point(u, v), -1).reshape(-1, 3)
    a = (np.arange(nu - 1)[:, None] * nv + np.arange(nv - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + nv], 1),
                            np.stack([a + 1, a + nv + 1, a + nv], 1)])
    return verts, faces


def room_mesh(rng: np.random.Generator):
    """(verts, faces) of the floor and six objects, 0.25-0.6 m in size."""
    parts = [_grid_surface(81, 81, lambda u, v: (4 * u, 4 * v, 0 * u))]
    for i in range(6):
        cx, cy = rng.uniform(0.7, 3.3, 2)
        s = rng.uniform(0.25, 0.6)
        kind = ("box", "sphere", "cylinder")[i % 3]
        if kind == "sphere":
            parts.append(_grid_surface(24, 48, lambda u, v: (
                cx + s * np.sin(np.pi * u) * np.cos(2 * np.pi * v),
                cy + s * np.sin(np.pi * u) * np.sin(2 * np.pi * v), s + s * np.cos(np.pi * u))))
        elif kind == "cylinder":
            parts.append(_grid_surface(16, 48, lambda u, v: (
                cx + s * np.cos(2 * np.pi * v), cy + s * np.sin(2 * np.pi * v), 2 * s * u)))
        else:
            for face in (lambda u, v: (cx + s * (2 * u - 1), cy + s * (2 * v - 1), 0 * u + s),
                         lambda u, v: (0 * u + cx - s, cy + s * (2 * u - 1), s * v),
                         lambda u, v: (0 * u + cx + s, cy + s * (2 * u - 1), s * v),
                         lambda u, v: (cx + s * (2 * u - 1), 0 * u + cy - s, s * v),
                         lambda u, v: (cx + s * (2 * u - 1), 0 * u + cy + s, s * v)):
                parts.append(_grid_surface(16, 16, face))
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def sample_mesh(verts, faces, n: int, rng: np.random.Generator) -> np.ndarray:
    """n points uniform over the mesh's area."""
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    t = tri[rng.choice(len(faces), size=n, p=areas / areas.sum())]
    u, v = rng.uniform(size=(2, n, 1))
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])


def noisy_room(mesh, n: int, sigma: float, outliers: float,
               rng: np.random.Generator) -> np.ndarray:
    """A scan [n, 3] f32 of a room ``mesh`` (verts, faces): surface samples,
    gaussian noise of ``sigma`` metres, and ``outliers`` of the points
    displaced by ten times that."""
    verts, faces = mesh
    pts = sample_mesh(verts, faces, n, rng)
    pts += rng.normal(size=pts.shape) * sigma
    sel = rng.choice(n, int(outliers * n), replace=False)
    pts[sel] += rng.normal(size=(len(sel), 3)) * (10 * sigma)
    return pts.astype(np.float32)
