"""Point-cloud transforms (copy of p2p_bridge_tpu/data/transforms.py; tests
hold the two equal).

The score-denoise transform stack of the PUNet pipeline (reference:
dataloaders/punet.py:16-207). All transforms operate on a dict with key
"pcl_clean" (N, 3) float32 and draw from an explicit numpy Generator.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    def __call__(self, data, rng: np.random.Generator):
        for t in self.transforms:
            data = t(data, rng)
        return data


def normalize_unit_sphere(pcl: np.ndarray, center=None, scale=None):
    """bbox-center + max-norm normalization (punet.py:16-41)."""
    if center is None:
        p_max = pcl.max(axis=0, keepdims=True)
        p_min = pcl.min(axis=0, keepdims=True)
        center = (p_max + p_min) / 2
    pcl = pcl - center
    if scale is None:
        scale = np.sqrt((pcl**2).sum(axis=1)).max()
    return pcl / scale, center, scale


class NormalizeUnitSphere:
    def __call__(self, data, rng):
        assert "pcl_noisy" not in data, "normalize before adding noise"
        data["pcl_clean"], center, scale = normalize_unit_sphere(data["pcl_clean"])
        data["center"] = center
        data["scale"] = scale
        return data


class AddNoise:
    """Gaussian noise with std uniform in [min, max] (punet.py:44-54)."""

    def __init__(self, noise_std_min: float, noise_std_max: float):
        self.noise_std_min = noise_std_min
        self.noise_std_max = noise_std_max

    def __call__(self, data, rng):
        std = rng.uniform(self.noise_std_min, self.noise_std_max)
        data["pcl_noisy"] = data["pcl_clean"] + rng.normal(
            size=data["pcl_clean"].shape
        ).astype(np.float32) * std
        data["noise_std"] = std
        return data


class AddLaplacianNoise:
    def __init__(self, noise_std_min: float, noise_std_max: float):
        self.noise_std_min = noise_std_min
        self.noise_std_max = noise_std_max

    def __call__(self, data, rng):
        std = rng.uniform(self.noise_std_min, self.noise_std_max)
        noise = rng.laplace(0, std, size=data["pcl_clean"].shape).astype(np.float32)
        data["pcl_noisy"] = data["pcl_clean"] + noise
        data["noise_std"] = std
        return data


class AddUniformBallNoise:
    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, data, rng):
        N = data["pcl_clean"].shape[0]
        phi = rng.uniform(0, 2 * np.pi, size=N)
        costheta = rng.uniform(-1, 1, size=N)
        u = rng.uniform(0, 1, size=N)
        theta = np.arccos(costheta)
        r = self.scale * u ** (1 / 3)
        noise = np.stack(
            [
                r * np.sin(theta) * np.cos(phi),
                r * np.sin(theta) * np.sin(phi),
                r * np.cos(theta),
            ],
            axis=1,
        ).astype(np.float32)
        data["pcl_noisy"] = data["pcl_clean"] + noise
        return data


class AddCovNoise:
    def __init__(self, cov, std_factor: float = 1.0):
        self.cov = np.asarray(cov, np.float64)
        self.std_factor = std_factor

    def __call__(self, data, rng):
        N = data["pcl_clean"].shape[0]
        noise = rng.multivariate_normal(np.zeros(3), self.cov, N).astype(np.float32)
        data["pcl_noisy"] = data["pcl_clean"] + noise * self.std_factor
        data["noise_std"] = self.std_factor
        return data


class AddDiscreteNoise:
    def __init__(self, scale: float, prob: float = 0.1):
        self.scale = scale
        self.prob = prob
        self.template = np.array(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
            dtype=np.float32,
        )

    def __call__(self, data, rng):
        N = data["pcl_clean"].shape[0]
        uni = rng.uniform(size=N)
        noise = np.zeros((N, 3), np.float32)
        for i in range(self.template.shape[0]):
            idx = (0.1 * i <= uni) & (uni < 0.1 * (i + 1))
            noise[idx] = self.template[i]
        data["pcl_noisy"] = data["pcl_clean"] + noise * self.scale
        data["noise_std"] = self.scale
        return data


class RandomScale:
    def __init__(self, scales):
        assert len(scales) == 2
        self.scales = scales

    def __call__(self, data, rng):
        scale = rng.uniform(*self.scales)
        data["pcl_clean"] = data["pcl_clean"] * scale
        if "pcl_noisy" in data:
            data["pcl_noisy"] = data["pcl_noisy"] * scale
        return data


def rotation_matrix(degree_rad: float, axis: int) -> np.ndarray:
    sin, cos = math.sin(degree_rad), math.cos(degree_rad)
    if axis == 0:
        return np.array([[1, 0, 0], [0, cos, sin], [0, -sin, cos]], np.float32)
    if axis == 1:
        return np.array([[cos, 0, -sin], [0, 1, 0], [sin, 0, cos]], np.float32)
    return np.array([[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]], np.float32)


class RandomRotate:
    def __init__(self, degrees=180.0, axis: int = 0):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.axis = axis

    def __call__(self, data, rng):
        degree = math.pi * rng.uniform(*self.degrees) / 180.0
        matrix = rotation_matrix(degree, self.axis)
        data["pcl_clean"] = data["pcl_clean"] @ matrix
        if "pcl_noisy" in data:
            data["pcl_noisy"] = data["pcl_noisy"] @ matrix
        return data


def standard_train_transforms(
    noise_std_min: float, noise_std_max: float, scale_d: float = 0.2, rotate: bool = True
) -> Compose:
    transforms = [
        NormalizeUnitSphere(),
        AddNoise(noise_std_min=noise_std_min, noise_std_max=noise_std_max),
        RandomScale([1.0 - scale_d, 1.0 + scale_d]),
    ]
    if rotate:
        transforms += [RandomRotate(axis=0), RandomRotate(axis=1), RandomRotate(axis=2)]
    return Compose(transforms)


def standard_train_transforms_clean(scale_d: float = 0.2, rotate: bool = True) -> Compose:
    transforms = [NormalizeUnitSphere(), RandomScale([1.0 - scale_d, 1.0 + scale_d])]
    if rotate:
        transforms += [RandomRotate(axis=0), RandomRotate(axis=1), RandomRotate(axis=2)]
    return Compose(transforms)


def random_rotate_horizontally(points: np.ndarray, theta: Optional[float] = None,
                               rng: Optional[np.random.Generator] = None):
    """z-axis rotation (reference: dataloaders/utils.py:7-34)."""
    if theta is None:
        theta = float((rng or np.random.default_rng()).uniform(0, 2 * np.pi))
    cos, sin = math.cos(theta), math.sin(theta)
    rot = np.array([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]], np.float32)
    return points @ rot.T, theta
