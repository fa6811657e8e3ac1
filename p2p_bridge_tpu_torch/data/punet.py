"""PUNet object-denoising dataset (copy of p2p_bridge_tpu/data/punet.py;
tests hold the two equal).

The score-denoise protocol (reference dataloaders/punet.py:210-445) on a
numpy host pipeline: .xyz clouds at three resolutions, kNN patch pairs cut
on the fly with per-patch recentring and rescaling.

Two patching paths:
  * ``PairedPatchDataset``: the literal port. Transform the full cloud
    (normalise -> noise -> scale -> rotate), then cut kNN patches; two
    cKDTrees per item.
  * ``FastPairedPatchDataset`` (the default for the standard gaussian
    stack): noise is drawn in normalised space and kNN is invariant under
    the uniform scale and rotations applied after it, so the patch is cut
    against ONE cached KD-tree per cloud and only the 2048-point patches
    are transformed. Same distribution, another RNG stream.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np
from scipy.spatial import cKDTree

from .transforms import Compose, standard_train_transforms, standard_train_transforms_clean


class PointCloudDataset:
    """Folder of .xyz clouds at one resolution (punet.py:210-234)."""

    def __init__(self, root, dataset, split, resolution, transform: Optional[Compose] = None):
        self.pcl_dir = os.path.join(root, dataset, "pointclouds", split, resolution)
        self.transform = transform
        self.pointclouds: List[np.ndarray] = []
        self.pointcloud_names: List[str] = []
        for fn in sorted(os.listdir(self.pcl_dir)):
            if fn[-3:] != "xyz":
                continue
            pcl = np.loadtxt(os.path.join(self.pcl_dir, fn), dtype=np.float32)
            self.pointclouds.append(pcl)
            self.pointcloud_names.append(fn[:-4])

    def __len__(self):
        return len(self.pointclouds)

    def normalized(self, idx: int):
        """(normalized cloud, cKDTree), built once per cloud and cached.
        Valid for the fast patch path: NormalizeUnitSphere is
        deterministic, so the base geometry never changes."""
        if not hasattr(self, "_norm_cache"):
            self._norm_cache = {}
        if idx not in self._norm_cache:
            from .transforms import normalize_unit_sphere

            pcl, center, scale = normalize_unit_sphere(
                self.pointclouds[idx].copy()
            )
            self._norm_cache[idx] = (
                pcl.astype(np.float32), cKDTree(pcl), center, scale
            )
        return self._norm_cache[idx]

    def get(self, idx: int, rng: np.random.Generator):
        data = {
            "pcl_clean": self.pointclouds[idx].copy(),
            "name": self.pointcloud_names[idx],
        }
        if self.transform is not None:
            data = self.transform(data, rng)
        return data


def make_patches_for_pcl_pair(pcl_a, pcl_b, patch_size, num_patches, ratio, rng):
    """Random-seed kNN patch pairs (punet.py:321-343).

    Seeds are drawn from pcl_a; patches are the patch_size NN in pcl_a
    and ratio*patch_size NN in pcl_b.
    Returns ([P, M, 3], [P, rM, 3]).
    """
    N = pcl_a.shape[0]
    seed_idx = rng.permutation(N)[:num_patches]
    seeds = pcl_a[seed_idx]
    tree_a = cKDTree(pcl_a)
    tree_b = cKDTree(pcl_b)
    _, idx_a = tree_a.query(seeds, k=patch_size)
    _, idx_b = tree_b.query(seeds, k=int(ratio * patch_size))
    return pcl_a[idx_a], pcl_b[idx_b]


class PairedPatchDataset:
    """On-the-fly paired patches (punet.py:346-422).

    Each item: pick a random resolution dataset, apply the transform
    stack (normalize + noise + scale + rotate), cut one kNN patch pair,
    recenter on the clean patch mean and rescale by the noisy patch max
    norm (punet.py:406-414).
    """

    def __init__(self, datasets, patch_ratio=1.0, patch_size=2048,
                 num_patches=1000, seed: int = 0):
        self.datasets = datasets
        self.len_datasets = sum(len(d) for d in datasets)
        self.patch_ratio = patch_ratio
        self.patch_size = patch_size
        self.num_patches = num_patches
        self.seed = seed

    def __len__(self):
        return self.len_datasets * self.num_patches

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        dset = self.datasets[rng.integers(len(self.datasets))]
        data = dset.get(idx % len(dset), rng)
        pat_noisy, pat_clean = make_patches_for_pcl_pair(
            data["pcl_noisy"], data["pcl_clean"],
            self.patch_size, 1, self.patch_ratio, rng,
        )
        noisy, clean = pat_noisy[0], pat_clean[0]
        center = clean.mean(axis=0)
        noisy = noisy - center
        clean = clean - center
        scale = np.linalg.norm(noisy, axis=1).max()
        noisy = noisy / scale
        clean = clean / scale
        return {
            "noisy_points": noisy.astype(np.float32),
            "clean_points": clean.astype(np.float32),
            "center": center.astype(np.float32),
            "scale": np.float32(scale),
        }


class FastPairedPatchDataset:
    """Patch-first paired patches, equivalent in distribution to
    PairedPatchDataset for the standard gaussian transform stack
    (see module docstring). 

    Exactness: candidates for the noisy-space kNN are the
    ``4 * patch_size`` base-nearest points of the seed; a point outside
    that set could enter the true noisy patch only if its noise
    displacement bridged the candidate-radius margin (>= several patch
    radii at the protocol's sigma <= 0.02) — probability ~0.
    """

    def __init__(self, datasets, noise_min=0.010, noise_max=0.020,
                 scale_d=0.2, rotate=True, patch_ratio=1.0,
                 patch_size=2048, num_patches=1000, seed: int = 0):
        self.datasets = datasets
        self.len_datasets = sum(len(d) for d in datasets)
        self.noise_min = noise_min
        self.noise_max = noise_max
        self.scale_d = scale_d
        self.rotate = rotate
        self.patch_ratio = patch_ratio
        self.patch_size = patch_size
        self.num_patches = num_patches
        self.seed = seed

    def __len__(self):
        return self.len_datasets * self.num_patches

    def __getitem__(self, idx):
        from .transforms import rotation_matrix

        rng = np.random.default_rng((self.seed, idx))
        dset = self.datasets[rng.integers(len(self.datasets))]
        clean_norm, tree, _, _ = dset.normalized(idx % len(dset))
        N = clean_norm.shape[0]
        ksize = self.patch_size
        kb = int(self.patch_ratio * ksize)

        std = rng.uniform(self.noise_min, self.noise_max) if self.noise_max > 0 else 0.0
        i0 = int(rng.integers(N))
        seed_pt = clean_norm[i0] + rng.normal(size=3).astype(np.float32) * std

        # noisy patch: exact kNN among the candidate neighborhood
        k_cand = min(4 * ksize, N) if kb <= 4 * ksize else min(kb, N)
        _, cand = tree.query(seed_pt, k=k_cand)
        noisy_cand = clean_norm[cand]
        if std > 0:
            noisy_cand = noisy_cand + rng.normal(
                size=noisy_cand.shape
            ).astype(np.float32) * std
            # in the literal path the seed IS a cloud point, so its noisy
            # position is the query point itself and the noisy patch
            # always contains the seed at distance 0 — reuse the seed's
            # noise draw as point i0's displacement to match
            pos = np.nonzero(cand == i0)[0]
            if pos.size:
                noisy_cand[pos[0]] = seed_pt
        d = ((noisy_cand - seed_pt) ** 2).sum(axis=1)
        sel = np.argpartition(d, ksize - 1)[:ksize]
        sel = sel[np.argsort(d[sel], kind="stable")]  # sorted, like tree.query
        noisy = noisy_cand[sel]

        # clean patch: the candidate query IS the base kNN, sorted —
        # its first kb entries are exactly tree.query(seed_pt, k=kb)
        clean = clean_norm[cand[:kb]]

        # the stack's post-noise transforms, applied to the patches only
        scale_aug = rng.uniform(1.0 - self.scale_d, 1.0 + self.scale_d)
        noisy = noisy * scale_aug
        clean = clean * scale_aug
        if self.rotate:
            mat = np.eye(3, dtype=np.float32)
            for axis in (0, 1, 2):
                degree = math.pi * rng.uniform(-180.0, 180.0) / 180.0
                mat = mat @ rotation_matrix(degree, axis)
            noisy = noisy @ mat
            clean = clean @ mat

        # per-patch recentering/rescaling (punet.py:406-414)
        center = clean.mean(axis=0)
        noisy = noisy - center
        clean = clean - center
        scale = np.linalg.norm(noisy, axis=1).max()
        noisy = noisy / scale
        clean = clean / scale
        return {
            "noisy_points": noisy.astype(np.float32),
            "clean_points": clean.astype(np.float32),
            "center": center.astype(np.float32),
            "scale": np.float32(scale),
        }


def get_dataset(
    dataset_root,
    split,
    dataset="PUNet",
    noise_min=0.010,
    noise_max=0.020,
    aug_rotate=True,
    patch_size=2048,
    resolutions=("10000_poisson", "30000_poisson", "50000_poisson"),
    seed: int = 0,
    fast: bool = True,
):
    """Standard PUNet training dataset (punet.py:266-290).

    fast=True (default) uses the patch-first FastPairedPatchDataset —
    the standard stack is gaussian noise only, for which it is exact in
    distribution; set fast=False for the literal full-cloud port."""
    if fast:
        return FastPairedPatchDataset(
            datasets=[
                PointCloudDataset(dataset_root, dataset, split, r, None)
                for r in resolutions
            ],
            noise_min=noise_min,
            noise_max=noise_max,
            rotate=aug_rotate,
            patch_ratio=1.0,
            patch_size=patch_size,
            seed=seed,
        )
    if noise_max > 0:
        transform = standard_train_transforms(
            noise_std_min=noise_min, noise_std_max=noise_max, rotate=aug_rotate
        )
    else:
        transform = standard_train_transforms_clean(rotate=aug_rotate)
    return PairedPatchDataset(
        datasets=[
            PointCloudDataset(dataset_root, dataset, split, r, transform)
            for r in resolutions
        ],
        patch_ratio=1.0,
        patch_size=patch_size,
        seed=seed,
    )
